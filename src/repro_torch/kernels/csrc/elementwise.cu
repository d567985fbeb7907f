// B4: elementwise activation (relu, silu, gelu in its tanh form, tanh,
// sigmoid) in fp32.
//
// Replaces repro/kernels/elementwise.py::elementwise (_ew_kernel), the
// Pallas kernel that pads the flat array to (rows, 128) lane tiles and
// applies the activation per VMEM block.
//
// Bound on the H100: one read and one write per element, so the bytes over
// 3.35 TB/s bound it.
//
// Design: one launch for any n.  When both pointers are 16-byte aligned a
// grid-stride loop moves 16 bytes per thread per step (float4) and the
// same threads then take the n % 4 tail; an unaligned view takes the
// scalar loop alone.  No padded copy.  y may equal x (the graph's in-place
// ReLU): each element is read and then written by one thread.  Computes
// in fp32 with the same formulas as the plain version (common.cuh).
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr long long MAX_BLOCKS = 132 * 16;

__global__ void ew_vec4(const float* __restrict__ x, float* __restrict__ y,
                        long long n, int act, int vec) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  long long done = 0;
  if (vec) {
    const long long n4 = n / 4;
    const float4* x4 = reinterpret_cast<const float4*>(x);
    float4* y4 = reinterpret_cast<float4*>(y);
    for (long long i = first; i < n4; i += step) {
      float4 v = x4[i];
      v.x = dlk_act(v.x, act);
      v.y = dlk_act(v.y, act);
      v.z = dlk_act(v.z, act);
      v.w = dlk_act(v.w, act);
      y4[i] = v;
    }
    done = 4 * n4;
  }
  for (long long i = done + first; i < n; i += step) y[i] = dlk_act(x[i], act);
}

long long blocks_for(long long n) {
  const long long b = (n + THREADS - 1) / THREADS;
  return b < MAX_BLOCKS ? b : MAX_BLOCKS;
}

}  // namespace

// y[i] = act(x[i]) for i < n; x and y contiguous fp32 (y may equal x).
extern "C" int dlk_elementwise_f32(const float* x, float* y, long long n, int act,
                                   cudaStream_t stream) {
  const int vec = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                  (reinterpret_cast<uintptr_t>(y) % 16 == 0);
  ew_vec4<<<static_cast<unsigned>(blocks_for(vec ? (n + 3) / 4 : n)), THREADS, 0,
            stream>>>(x, y, n, act, vec);
  return dlk_last_error();
}
