// B3's windowed route against the designs it was chosen over, on one CUDA
// card, at NIN-CIFAR10's two windowed pools (max 3/2/1 on B x 96 x 32 x 32,
// avg 3/2/1 on B x 192 x 16 x 16) at batch 1, 8 and 64:
//
//   naive    the kernel the port had before: one thread an output over the
//            flat output in a grid-stride loop (64-bit index arithmetic)
//   staged   the tile's input rows staged in shared memory first, by
//            cp.async (16 bytes where aligned) or by plain loads and
//            stores, then each window reduced from shared memory
//   shipped  csrc/pool.cu's pool2d_window: the same CTA shape, each window
//            read through the read-only cache
//
// Build and run on the machine with the card, from the repo root:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//        -o build/pool_variants benchmarks/pool_variants.cu
//   build/pool_variants
//
// Prints one JSON line per case: µs per launch (CUDA events over 200
// back-to-back launches, the best of 5), and whether every variant's
// output equals the shipped kernel's bit for bit.
#include <algorithm>
#include <cstdio>
#include <vector>

#include "../src/repro_torch/kernels/csrc/pool.cu"

namespace {

__global__ void naive(const float* __restrict__ x, float* __restrict__ y,
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
        acc = is_max ? ((v > acc || v != v) ? v : acc) : acc + v;
        ++count;
      }
    }
    y[i] = is_max ? acc : acc / static_cast<float>(count);
  }
}

// The staged variant: the CTA's plane tile is whole output rows (no column
// bands); its (rows - 1) * stride + K input rows, from the tile's first
// window column floored to 4, go to shared memory (halo: -inf or 0).
template <int K, bool IS_MAX, bool ASYNC>
__global__ void staged(const float* __restrict__ x, float* __restrict__ y,
                       DlkPoolPlan g, int in_rows, int row_stride) {
  extern __shared__ float4 smem4[];
  float* s = reinterpret_cast<float*>(smem4);
  const int rb = blockIdx.x % g.row_bands;
  const long long p0 = static_cast<long long>(blockIdx.x / g.row_bands) * g.planes;
  const int np = static_cast<int>(min(static_cast<long long>(g.planes), g.bc - p0));
  const int oh0 = rb * g.band_rows, nr = min(g.band_rows, g.oh - oh0);
  const int h_start = oh0 * g.stride - g.pad, wa = -g.pad & ~3, off = -g.pad - wa;
  const int rows = (nr - 1) * g.stride + K;
  const int quads = (off + (g.ow - 1) * g.stride + K + 3) / 4;
  const int slab = in_rows * row_stride;
  const float fill = IS_MAX ? -INFINITY : 0.0f;
  const int tid = (threadIdx.z * blockDim.y + threadIdx.y) * blockDim.x + threadIdx.x;
  const int threads = blockDim.x * blockDim.y * blockDim.z;
  for (int i = tid; i < np * rows * quads; i += threads) {
    const int q = i % quads, rr = i / quads, pl = rr / rows, r = rr - pl * rows;
    const int ih = h_start + r, iw = wa + 4 * q;
    const bool row_ok = ih >= 0 && ih < g.h;
    const float* src = x + ((p0 + pl) * g.h + ih) * g.w + iw;
    float* dst = s + pl * slab + r * row_stride + 4 * q;
    if (row_ok && iw >= 0 && iw + 3 < g.w) {
      if (ASYNC) {
        dlk_cp_async16(dst, src, true);
      } else {
        *reinterpret_cast<float4*>(dst) = __ldg(reinterpret_cast<const float4*>(src));
      }
    } else {
      for (int e = 0; e < 4; ++e) {
        dst[e] = row_ok && iw + e >= 0 && iw + e < g.w ? src[e] : fill;
      }
    }
  }
  if (ASYNC) {
    dlk_cp_async_commit();
    dlk_cp_async_wait<0>();
  }
  __syncthreads();
  const int c = threadIdx.x, r = threadIdx.y, pl = threadIdx.z;
  if (r >= nr || pl >= np) return;
  const float* win = s + pl * slab + r * g.stride * row_stride + off + c * g.stride;
  float acc = IS_MAX ? -INFINITY : 0.0f;
#pragma unroll
  for (int di = 0; di < K; ++di) {
#pragma unroll
    for (int dj = 0; dj < K; ++dj) {
      const float v = win[di * row_stride + dj];
      acc = IS_MAX ? max_nan(acc, v) : acc + v;
    }
  }
  const int oh = oh0 + r;
  if (!IS_MAX) {
    const int h0 = oh * g.stride - g.pad, w0 = c * g.stride - g.pad;
    const int ch = max(0, min(h0 + K, g.h) - max(h0, 0));
    const int cw = max(0, min(w0 + K, g.w) - max(w0, 0));
    acc = acc / static_cast<float>(ch * cw);
  }
  y[((p0 + pl) * g.oh + oh) * g.ow + c] = acc;
}

// The windowed plan of kernels/pool.py::plan on `sms` SMs.
DlkPoolPlan window_plan(int b, int c, int h, int w, int k, int s, int p,
                        bool is_max, int sms) {
  DlkPoolPlan g{};
  g.bc = b * c, g.h = h, g.w = w, g.kernel = k, g.stride = s, g.pad = p;
  g.is_max = is_max, g.route = 1;
  g.oh = (h + 2 * p - k) / s + 1, g.ow = (w + 2 * p - k) / s + 1;
  g.band_cols = g.ow, g.band_rows = g.oh;
  while (g.band_rows * g.band_cols > 1024) g.band_rows = (g.band_rows + 1) / 2;
  g.planes = std::max(1, std::min({g.bc, 64, 256 / (g.band_rows * g.band_cols)}));
  g.row_bands = (g.oh + g.band_rows - 1) / g.band_rows, g.col_bands = 1;
  auto ctas = [&] { return (g.bc + g.planes - 1) / g.planes * g.row_bands; };
  while (ctas() < sms && g.planes > 1) g.planes = (g.planes + 1) / 2;
  g.grid = ctas(), g.block = g.planes * g.band_rows * g.band_cols;
  return g;
}

template <typename F>
float best_us(F launch) {
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  for (int i = 0; i < 20; ++i) launch();
  cudaDeviceSynchronize();
  float best = 1e30f;
  for (int rep = 0; rep < 5; ++rep) {
    cudaEventRecord(a);
    for (int i = 0; i < 200; ++i) launch();
    cudaEventRecord(b);
    cudaEventSynchronize(b);
    float ms = 0.0f;
    cudaEventElapsedTime(&ms, a, b);
    best = std::min(best, 1e3f * ms / 200);
  }
  cudaEventDestroy(a);
  cudaEventDestroy(b);
  return best;
}

template <bool IS_MAX>
void run_case(const float* x, float* y0, float* y1, int b, int c, int hw, int sms) {
  const DlkPoolPlan g = window_plan(b, c, hw, hw, 3, 2, 1, IS_MAX, sms);
  const long long total = static_cast<long long>(g.bc) * g.oh * g.ow;
  const int in_rows = (g.band_rows - 1) * g.stride + g.kernel;
  const int row_stride = (3 + (g.ow - 1) * g.stride + g.kernel + 3) / 4 * 4;
  const int smem = 4 * g.planes * in_rows * row_stride;
  const dim3 block(g.band_cols, g.band_rows, g.planes);
  const unsigned naive_blocks = static_cast<unsigned>(
      std::min<long long>((total + 255) / 256, 132 * 32));
  std::vector<float> want(total), got(total);
  auto same = [&](float* y) {
    cudaMemcpy(got.data(), y, total * 4, cudaMemcpyDeviceToHost);
    for (long long i = 0; i < total; ++i) {
      if (got[i] != want[i]) return false;
    }
    return true;
  };
  auto shipped = [&] { pool2d_window<3, IS_MAX><<<g.grid, block>>>(x, y0, g); };
  auto nv = [&] {
    naive<<<naive_blocks, 256>>>(x, y1, total, g.h, g.w, g.oh, g.ow, 3, 2, 1, IS_MAX);
  };
  auto st_async = [&] {
    staged<3, IS_MAX, true><<<g.grid, block, smem>>>(x, y1, g, in_rows, row_stride);
  };
  auto st_plain = [&] {
    staged<3, IS_MAX, false><<<g.grid, block, smem>>>(x, y1, g, in_rows, row_stride);
  };
  shipped();
  cudaMemcpy(want.data(), y0, total * 4, cudaMemcpyDeviceToHost);
  nv();
  bool equal = same(y1);
  st_async();
  equal = equal && same(y1);
  st_plain();
  equal = equal && same(y1);
  printf("{\"pool\": \"%s 3/2/1\", \"shape\": [%d, %d, %d, %d], \"ctas\": %d, "
         "\"block\": [%d, %d, %d], \"naive_us\": %.3f, \"staged_cp_async_us\": %.3f, "
         "\"staged_plain_us\": %.3f, \"shipped_us\": %.3f, \"bit_equal\": %s, "
         "\"error\": \"%s\"}\n",
         IS_MAX ? "max" : "avg", b, c, hw, hw, g.grid, g.band_cols, g.band_rows,
         g.planes, best_us(nv), best_us(st_async), best_us(st_plain),
         best_us(shipped), equal ? "true" : "false",
         cudaGetErrorString(cudaGetLastError()));
}

}  // namespace

int main() {
  cudaDeviceProp prop;
  cudaGetDeviceProperties(&prop, 0);
  printf("{\"device\": \"%s\", \"sms\": %d}\n", prop.name, prop.multiProcessorCount);
  const long long n = 64LL * 192 * 16 * 16 * 2;   // the larger input of the two
  std::vector<float> host(n);
  unsigned state = 12345u;
  for (auto& v : host) {
    state = state * 1664525u + 1013904223u;
    v = static_cast<float>(state >> 8) / 16777216.0f * 6.0f - 3.0f;
  }
  float *x, *y0, *y1;
  cudaMalloc(&x, n * 4);
  cudaMalloc(&y0, n * 4);
  cudaMalloc(&y1, n * 4);
  cudaMemcpy(x, host.data(), n * 4, cudaMemcpyHostToDevice);
  for (int b : {1, 8, 64}) {
    run_case<true>(x, y0, y1, b, 96, 32, prop.multiProcessorCount);
    run_case<false>(x, y0, y1, b, 192, 16, prop.multiProcessorCount);
  }
  cudaFree(x);
  cudaFree(y0);
  cudaFree(y1);
  return 0;
}
