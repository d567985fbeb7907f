// B3: K x K stride-s max / average pooling over (B*C) planes.
//
// Replaces repro/kernels/pool.py::pool2d (_pool_kernel, _avg_kernel), the
// Pallas kernel that pads the input planes with -inf (max) or 0 (avg),
// reduces the K*K shifted strided views of a block of planes in VMEM, and
// multiplies by a precomputed reciprocal-count array for the average.
//
// Bound on the H100: a few operations per element, so the bytes (each input
// read once, each output written once, over 3.35 TB/s) bound it; NIN's
// largest pool reads 3 MB per image.
//
// Design: one thread per output element over B*C*OH*OW in a grid-stride
// loop; neighbouring threads own neighbouring outputs of one row, so their
// window reads overlap and are served from L1.  The window loop visits only
// the in-bounds taps, in the same row-major order as the plain version, so
// there is no padded copy of the input: max starts at -inf, and the average
// divides the sum by the number of in-bounds taps (Caffe's count that
// excludes padding), which replaces the TPU version's denominator array.
#include <math.h>

#include "common.cuh"

namespace {

__global__ void pool2d_kernel(const float* __restrict__ x, float* __restrict__ y,
                              long long total, int H, int W, int OH, int OW,
                              int kernel, int stride, int pad, int is_max) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < total; i += step) {
    const int ow = static_cast<int>(i % OW);
    const long long t = i / OW;
    const int oh = static_cast<int>(t % OH);
    const long long plane = t / OH;
    const float* xp = x + plane * H * W;
    const int h0 = oh * stride - pad, w0 = ow * stride - pad;
    float acc = is_max ? -INFINITY : 0.0f;
    int count = 0;
    for (int di = 0; di < kernel; ++di) {
      const int h = h0 + di;
      if (h < 0 || h >= H) continue;
      for (int dj = 0; dj < kernel; ++dj) {
        const int w = w0 + dj;
        if (w < 0 || w >= W) continue;
        const float v = xp[h * W + w];
        if (is_max) {
          acc = (v > acc || v != v) ? v : acc;   // NaN wins, as in lax.max
        } else {
          acc += v;
        }
        ++count;
      }
    }
    y[i] = is_max ? acc : acc / static_cast<float>(count);
  }
}

}  // namespace

// x (BC, H, W) contiguous -> y (BC, OH, OW) contiguous.
extern "C" int dlk_pool2d_f32(const float* x, float* y, int BC, int H, int W,
                              int OH, int OW, int kernel, int stride, int pad,
                              int is_max, cudaStream_t stream) {
  const long long total = static_cast<long long>(BC) * OH * OW;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  pool2d_kernel<<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      x, y, total, H, W, OH, OW, kernel, stride, pad, is_max);
  return dlk_last_error();
}
