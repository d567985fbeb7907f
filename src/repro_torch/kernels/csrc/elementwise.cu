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
// Design: a grid-stride loop that moves 16 bytes per thread per step
// (float4) when both pointers are 16-byte aligned, and a scalar loop for
// the tail or an unaligned view.  No padded copy.  Computes in fp32 with
// the same formulas as the plain version (common.cuh).
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr long long MAX_BLOCKS = 132 * 16;

__global__ void ew_vec4(const float4* __restrict__ x, float4* __restrict__ y,
                        long long n4, int act) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n4; i += step) {
    float4 v = x[i];
    v.x = dlk_act(v.x, act);
    v.y = dlk_act(v.y, act);
    v.z = dlk_act(v.z, act);
    v.w = dlk_act(v.w, act);
    y[i] = v;
  }
}

__global__ void ew_scalar(const float* __restrict__ x, float* __restrict__ y,
                          long long start, long long n, int act) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = start + static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += step) {
    y[i] = dlk_act(x[i], act);
  }
}

long long blocks_for(long long n) {
  const long long b = (n + THREADS - 1) / THREADS;
  return b < MAX_BLOCKS ? b : MAX_BLOCKS;
}

}  // namespace

// y[i] = act(x[i]) for i < n; x and y contiguous fp32 (y may equal x).
extern "C" int dlk_elementwise_f32(const float* x, float* y, long long n, int act,
                                   cudaStream_t stream) {
  const bool aligned = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(y) % 16 == 0);
  const long long n4 = aligned ? n / 4 : 0;
  if (n4 > 0) {
    ew_vec4<<<static_cast<unsigned>(blocks_for(n4)), THREADS, 0, stream>>>(
        reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(y), n4, act);
  }
  const long long rest = n - 4 * n4;
  if (rest > 0) {
    ew_scalar<<<static_cast<unsigned>(blocks_for(rest)), THREADS, 0, stream>>>(
        x, y, 4 * n4, n, act);
  }
  return dlk_last_error();
}
