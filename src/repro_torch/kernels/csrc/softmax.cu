// B5: numerically stable fp32 softmax over the rows of (R, N).
//
// Replaces repro/kernels/softmax.py::softmax (_softmax_kernel), the Pallas
// kernel that pads columns to 128 lanes with -inf and normalises a block of
// rows per VMEM tile.
//
// Bound on the H100: a few operations per element, so the bytes (one read,
// one write per element) bound it; at NIN's (B, 10) the launch itself is
// the cost.
//
// Design: one warp per row, four rows per 128-thread block.  Three passes
// over the row, each lane striding by 32: the maximum, the sum of
// exp(x - max), then exp(x - max) / sum; the two reductions are warp
// shuffles, so nothing goes through shared memory and no column is padded.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int WARPS = 4;
constexpr unsigned FULL = 0xffffffffu;

__global__ void softmax_rows(const float* __restrict__ x, float* __restrict__ y,
                             int R, int N) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long row = static_cast<long long>(blockIdx.x) * WARPS + warp;
  if (row >= R) return;   // the whole warp leaves together
  const float* xr = x + row * N;
  float* yr = y + row * N;
  float m = -INFINITY;
  for (int j = lane; j < N; j += 32) m = fmaxf(m, xr[j]);
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, o));
  float s = 0.0f;
  for (int j = lane; j < N; j += 32) s += expf(xr[j] - m);
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
  for (int j = lane; j < N; j += 32) yr[j] = expf(xr[j] - m) / s;
}

}  // namespace

// y (R, N) = softmax of x (R, N) over each row; both contiguous fp32.
extern "C" int dlk_softmax_f32(const float* x, float* y, int R, int N,
                               cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((R + WARPS - 1) / WARPS);
  softmax_rows<<<blocks, WARPS * 32, 0, stream>>>(x, y, R, N);
  return dlk_last_error();
}
