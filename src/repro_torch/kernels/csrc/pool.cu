// B3: K x K stride-s max / average pooling over (B*C) planes.
//
// Replaces repro/kernels/pool.py::pool2d (_pool_kernel, _avg_kernel), the
// Pallas kernel that pads the input planes with -inf (max) or 0 (avg),
// reduces the K*K shifted strided views of a block of planes in VMEM, and
// multiplies by a precomputed reciprocal-count array for the average.
//
// Bound on the H100: a few operations per element, so the bytes (each input
// read once, each output written once, over 3.35 TB/s) bound it; NIN's
// largest pool reads 3 MB per image.  At the CNN's small batches a launch
// moves tens of KB, so what the device time is made of is load latency.
//
// Semantics, as the plain version (kernels/ref.py::pool2d_ref): max starts
// at -inf over the in-bounds taps and NaN wins, as lax.max does; avg adds
// the taps in the window's row-major order and divides by the number of
// in-bounds taps (Caffe's count, which excludes padding).  Both routes keep
// that order, so each result is bit-equal to the plain version's.
//
// Design: two routes, picked on the host by kernels/pool.py::plan and
// described to the entry point by one cached DlkPoolPlan.
//  (a) Plane reduction, for one output per plane and no padding (NIN's
//      global average pool, 8/1/0 on 8 x 8): one warp per plane, the
//      planes spread over CTAs of 1-4 warps so that they reach many SMs.
//      The lanes load a chunk of the window at once, 16 bytes a lane where
//      the window is the contiguous start of an aligned plane, so the load
//      latency is paid once a chunk and not once a tap.  Max: each lane's
//      maximum, then a shuffle tree (max is exact in any order).  Avg: the
//      chunk goes to shared memory and lane 0 adds it in row-major order,
//      a serial chain of FADDs on shared memory.
//  (b) Windowed, for every other shape: a CTA is a (columns, rows, planes)
//      block of threads over a tile of output rows and columns of one or
//      several planes, one thread an output, so no thread divides to find
//      its output.  Each thread reads its in-bounds taps in row-major order
//      through the read-only cache, where its neighbours' overlapping
//      windows hit; K = 2 and 3 are fully unrolled.  Staging the tile's
//      input rows in shared memory first (cp.async or plain loads), as
//      the windows' overlap suggests, was 15-26 % slower at NIN's pools
//      at batch 8 and 64, and from 6 % faster to 10 % slower at batch 1
//      (benchmarks/pool_variants.cu), so the route does not stage.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

// The geometry and launch configuration of one call, made and cached by
// kernels/pool.py (class PoolPlan there, field for field).
struct DlkPoolPlan {
  int bc, h, w, oh, ow, kernel, stride, pad, is_max;
  int route;                 // 0: plane reduction, 1: windowed
  int grid, block, smem;     // CTAs, threads a CTA, (a) dynamic shared bytes
  int planes;                // (b) planes a CTA: the block's z
  int band_rows, band_cols;  // (b) output rows and columns a CTA: its y, x
  int row_bands, col_bands;  // (b) bands a plane
};
static_assert(sizeof(DlkPoolPlan) == 18 * sizeof(int), "PoolPlan's layout");

namespace {

constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float max_nan(float acc, float v) {
  return (v > acc || v != v) ? v : acc;   // NaN wins, as in lax.max
}

// (a): warp w of CTA b reduces plane b * warps + w.  Max needs no shared
// memory; avg stages chunks of smem / (4 * warps) floats a warp.
template <bool IS_MAX>
__global__ void pool2d_plane(const float* __restrict__ x, float* __restrict__ y,
                             DlkPoolPlan g) {
  extern __shared__ float4 plane_smem[];
  const int warps = blockDim.x / 32, warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long plane = static_cast<long long>(blockIdx.x) * warps + warp;
  if (plane >= g.bc) return;                 // the whole warp leaves together
  const int k = g.kernel, n = k * k;
  const float* xp = x + plane * g.h * g.w;
  // the window is the first k rows and columns of the plane: one
  // contiguous run when it spans the rows' full width
  const bool run = k == g.w;
  const bool vec = run && reinterpret_cast<uintptr_t>(xp) % 16 == 0;
  auto tap = [&](int e) {                    // row-major tap e of the window
    return run ? xp[e] : xp[(e / k) * g.w + e % k];
  };
  if (IS_MAX) {
    float acc = -INFINITY;
    int e0 = 0;
    if (vec) {
      const float4* x4 = reinterpret_cast<const float4*>(xp);
      for (int i = lane; i < n / 4; i += 32) {
        const float4 v = x4[i];
        acc = max_nan(max_nan(max_nan(max_nan(acc, v.x), v.y), v.z), v.w);
      }
      e0 = n / 4 * 4;
    }
    for (int e = e0 + lane; e < n; e += 32) acc = max_nan(acc, tap(e));
    for (int o = 16; o > 0; o >>= 1) acc = max_nan(acc, __shfl_xor_sync(FULL, acc, o));
    if (lane == 0) y[plane] = acc;
    return;
  }
  const int chunk = g.smem / (4 * warps);    // a multiple of 4
  float* stage = reinterpret_cast<float*>(plane_smem) + warp * chunk;
  float acc = 0.0f;
  for (int base = 0; base < n; base += chunk) {
    const int len = min(chunk, n - base);
    int e0 = 0;
    if (vec) {
      const float4* x4 = reinterpret_cast<const float4*>(xp + base);
      float4* s4 = reinterpret_cast<float4*>(stage);
      for (int i = lane; i < len / 4; i += 32) s4[i] = x4[i];
      e0 = len / 4 * 4;
    }
    for (int e = e0 + lane; e < len; e += 32) stage[e] = tap(base + e);
    __syncwarp();
    if (lane == 0) {
#pragma unroll 16
      for (int e = 0; e < len; ++e) acc += stage[e];
    }
    __syncwarp();
  }
  if (lane == 0) y[plane] = acc / static_cast<float>(n);
}

// (b): CTA t owns plane group t / (row_bands * col_bands), and in it one
// band of output rows and one of output columns; thread (x, y, z) computes
// output column x, row y of plane z of the tile.  K = 0: the window from
// the plan, in a loop.
template <int K, bool IS_MAX>
__global__ void pool2d_window(const float* __restrict__ x, float* __restrict__ y,
                              DlkPoolPlan g) {
  const int k = K ? K : g.kernel;
  int t = blockIdx.x;
  const int cb = t % g.col_bands;
  t /= g.col_bands;
  const int rb = t % g.row_bands;
  const long long plane = static_cast<long long>(t / g.row_bands) * g.planes + threadIdx.z;
  const int oh = rb * g.band_rows + threadIdx.y, ow = cb * g.band_cols + threadIdx.x;
  if (plane >= g.bc || oh >= g.oh || ow >= g.ow) return;
  const float* xp = x + plane * g.h * g.w;
  const int h0 = oh * g.stride - g.pad, w0 = ow * g.stride - g.pad;
  float acc = IS_MAX ? -INFINITY : 0.0f;
#pragma unroll
  for (int di = 0; di < k; ++di) {
    const int h = h0 + di;
#pragma unroll
    for (int dj = 0; dj < k; ++dj) {
      const int w = w0 + dj;
      if (h >= 0 && h < g.h && w >= 0 && w < g.w) {
        const float v = __ldg(xp + h * g.w + w);
        acc = IS_MAX ? max_nan(acc, v) : acc + v;
      }
    }
  }
  if (!IS_MAX) {
    const int ch = max(0, min(h0 + k, g.h) - max(h0, 0));
    const int cw = max(0, min(w0 + k, g.w) - max(w0, 0));
    acc = acc / static_cast<float>(ch * cw);
  }
  y[(plane * g.oh + oh) * g.ow + ow] = acc;
}

template <int K, bool IS_MAX>
int launch_window(const float* x, float* y, const DlkPoolPlan& g,
                  cudaStream_t stream) {
  const dim3 block(g.band_cols, g.band_rows, g.planes);
  pool2d_window<K, IS_MAX><<<g.grid, block, 0, stream>>>(x, y, g);
  return dlk_last_error();
}

template <bool IS_MAX>
int launch(const float* x, float* y, const DlkPoolPlan& g, cudaStream_t stream) {
  if (g.route == 0) {
    pool2d_plane<IS_MAX><<<g.grid, g.block, g.smem, stream>>>(x, y, g);
    return dlk_last_error();
  }
  switch (g.kernel) {
    case 2: return launch_window<2, IS_MAX>(x, y, g, stream);
    case 3: return launch_window<3, IS_MAX>(x, y, g, stream);
    default: return launch_window<0, IS_MAX>(x, y, g, stream);
  }
}

}  // namespace

// x (BC, H, W) contiguous -> y (BC, OH, OW) contiguous, as *plan says.
extern "C" int dlk_pool2d_f32(const float* x, float* y, const DlkPoolPlan* plan,
                              cudaStream_t stream) {
  return plan->is_max ? launch<true>(x, y, *plan, stream)
                      : launch<false>(x, y, *plan, stream);
}
