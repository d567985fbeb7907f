// B10: the chunked RWKV-6 WKV from a zero state (prefill, and the forward
// without grad): r, k, v, w (B, T, H, N) fp32 or bf16 and the bonus u
// (H, N) fp32 -> out (B, T, H, N) in the inputs' dtype and the final state
// (B, H, N, N) fp32, for head sizes N 32 and 64.
//
// Replaces repro/kernels/rwkv6_chunk.py::rwkv6_chunked (body _wkv_kernel).
// On the TPU the grid (B, H, T/16) walks the chunks of one head in order
// and carries the N x N state in VMEM scratch from one grid step to the
// next; its wrapper pads T to a multiple of 16 with w = 1 by a copy.
//
// Per 16-token chunk, with lw = log(clip(w, 1e-26, 1)) and cum its column
// cumsum over the chunk:
//   att[i, j] = sum_n r_in k_jn exp(clip(cum_in - lw_in - cum_jn, -60, 0))
//               for j < i, and sum_n r_in k_in u_n on the diagonal;
//   out_i     = sum_j<=i att[i, j] v_j + (r_i * exp(cum_i - lw_i)) . S;
//   S[n, m]  <- exp(cum_last_n) S[n, m]
//               + sum_j k_jn exp(cum_last_n - cum_jn) v_jm.
// S[n, m]: n is the key dimension (scaled by the decay), m the value one.
//
// Bound on the H100: the bytes at the shapes the model gives it (four
// inputs read once, out and state written once; about 16 operations per
// byte at N 64, under the fp32 ridge of ~20), but this design is bound by
// its sequential chunk loop and shared-memory traffic, not by either.
//
// Design (a simple kernel that is right first):
//  - one CTA of 256 threads per (head, batch); the chunk loop runs inside
//    the CTA, the N x N state lives in shared memory (16 KB at N 64);
//  - each chunk's r, k, v and log w tiles are staged in shared memory; a
//    token past T is read as k = v = r = 0 and w = 1, which leaves the
//    state unchanged, and only rows < T are written (no padding copy);
//  - the column cumsum is done by N threads; the 136 pairs (j <= i) of the
//    chunk's attention are dot products over N split across a warp's lanes
//    and reduced by shuffles; the upper triangle (j > i) is skipped, so no
//    exp of a positive exponent is ever taken;
//  - thread (g, m), g = tid / N, owns value column m of 16 / (256 / N)
//    output rows and of N / (256 / N) state rows; the state rows it
//    updates are its own, so the update needs no atomics;
//  - the arithmetic is fp64 on the fp32 inputs (FP64 runs at half the fp32
//    rate on the H100, and the loop is not bound by it), each output
//    rounded to fp32 once, the state stored in fp32 after each chunk as
//    the reference stores it.  In fp32, the cumsum's rounding (~1e-6 in an
//    exponent near 0) and sums of terms up to ~30 that cancel put the
//    reference itself ~1e-5 from the exact value; in fp64 the kernel is
//    within fp32 rounding of it, which the card's check holds.
//
// Not yet done (a later PR): the grid is B x H CTAs (40 at prefill batch 1
// for 132 SMs), each sequential over the chunks; value columns m are
// independent and would split the grid, and the products would go to
// tensor cores.
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int C = 16;               // tokens per chunk
constexpr int THREADS = 256;
constexpr int PAIRS = C * (C + 1) / 2;
constexpr double NEG_BIG = -60.0;   // floor of the in-chunk decay exponents
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int N, typename T>
__global__ void __launch_bounds__(THREADS)
wkv_chunked_kernel(const T* __restrict__ r, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ w,
                   const float* __restrict__ u, T* __restrict__ out,
                   float* __restrict__ state, int Tlen, int H) {
  constexpr int G = THREADS / N;    // thread groups: 4 at N 64, 8 at N 32
  constexpr int OUT_ROWS = C / G;   // output rows a thread writes
  constexpr int S_ROWS = N / G;     // state rows a thread updates
  static_assert(THREADS % N == 0 && C % G == 0 && N % G == 0, "shape");

  __shared__ float S[N][N];
  __shared__ float rs[C][N], ks[C][N], vs[C][N];  // r, k: then decayed
  __shared__ double cum[C][N];      // log w, then its cumsum over the chunk
  __shared__ double att[C][C];      // j < i pairs; the bonus on the diagonal
  __shared__ float us[N];
  __shared__ double cl[N], dl[N];   // cum_last, exp(cum_last)

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m = tid % N, g = tid / N;
  const size_t row = static_cast<size_t>(H) * N;       // elements per token
  const size_t base = static_cast<size_t>(b) * Tlen * row +
                      static_cast<size_t>(h) * N;       // (b, 0, h, 0)

  for (int idx = tid; idx < N * N; idx += THREADS) (&S[0][0])[idx] = 0.0f;
  if (tid < N) us[tid] = u[h * N + tid];

  const int nc = (Tlen + C - 1) / C;
  for (int c = 0; c < nc; ++c) {
    const int t0 = c * C;
    // 1. stage the chunk; tokens past T: r = k = v = 0, w = 1 (log w = 0)
    for (int idx = tid; idx < C * N; idx += THREADS) {
      const int i = idx / N, n = idx % N, t = t0 + i;
      float rv = 0.0f, kv = 0.0f, vv = 0.0f;
      double lw = 0.0;
      if (t < Tlen) {
        const size_t o = base + static_cast<size_t>(t) * row + n;
        rv = load(r + o);
        kv = load(k + o);
        vv = load(v + o);
        lw = log(static_cast<double>(fminf(fmaxf(load(w + o), 1e-26f), 1.0f)));
      }
      rs[i][n] = rv;
      ks[i][n] = kv;
      vs[i][n] = vv;
      cum[i][n] = lw;
    }
    __syncthreads();
    // 2. the column cumsum of log w, one thread per column
    if (tid < N) {
      double acc = 0.0;
      for (int i = 0; i < C; ++i) {
        acc += cum[i][tid];
        cum[i][tid] = acc;
      }
      cl[tid] = acc;
      dl[tid] = exp(acc);
    }
    __syncthreads();
    // 3. the pairs j <= i, one warp per pair; the exponent of (i, j < i) is
    //    cum_{i-1} - cum_j <= 0, clipped to -60 as in the reference
    for (int p = warp; p < PAIRS; p += THREADS / 32) {
      int i = 0;
      while ((i + 1) * (i + 2) / 2 <= p) ++i;
      const int j = p - i * (i + 1) / 2;
      double acc = 0.0;
      for (int n = lane; n < N; n += 32) {
        const double rk = static_cast<double>(rs[i][n]) * ks[j][n];
        if (j < i) {
          const double e = (i > 0 ? cum[i - 1][n] : 0.0) - cum[j][n];
          acc += rk * exp(fmin(fmax(e, NEG_BIG), 0.0));
        } else {
          acc += rk * us[n];
        }
      }
      for (int off = 16; off; off >>= 1) acc += __shfl_xor_sync(FULL, acc, off);
      if (lane == 0) att[i][j] = acc;
    }
    __syncthreads();
    // 4. r decayed to token i's start, k decayed to the chunk's end, in place
    for (int idx = tid; idx < C * N; idx += THREADS) {
      const int i = idx / N, n = idx % N;
      rs[i][n] = static_cast<float>(rs[i][n] * exp(i > 0 ? cum[i - 1][n] : 0.0));
      ks[i][n] = static_cast<float>(ks[i][n] * exp(cl[n] - cum[i][n]));
    }
    __syncthreads();
    // 5. out_i = att v (+ the bonus) + (r decayed) . S, rows < T only
    for (int q = 0; q < OUT_ROWS; ++q) {
      const int i = g + q * G;
      double intra = 0.0;
      for (int j = 0; j <= i; ++j) intra += att[i][j] * vs[j][m];
      double inter = 0.0;
#pragma unroll 8
      for (int n = 0; n < N; ++n)
        inter += static_cast<double>(rs[i][n]) * S[n][m];
      if (t0 + i < Tlen)
        store(out + base + static_cast<size_t>(t0 + i) * row + m,
              static_cast<float>(intra + inter));
    }
    __syncthreads();
    // 6. S <- diag(exp(cum_last)) S + kd^T v, each thread its own entries
    for (int q = 0; q < S_ROWS; ++q) {
      const int n = g + q * G;
      double kv = 0.0;
#pragma unroll
      for (int j = 0; j < C; ++j) kv += static_cast<double>(ks[j][n]) * vs[j][m];
      S[n][m] = static_cast<float>(S[n][m] * dl[n] + kv);
    }
    __syncthreads();
  }
  float* st = state + (static_cast<size_t>(b) * H + h) * N * N;
  for (int idx = tid; idx < N * N; idx += THREADS) st[idx] = (&S[0][0])[idx];
}

template <int N, typename T>
int launch(const void* r, const void* k, const void* v, const void* w,
           const float* u, void* out, float* state, int B, int Tlen, int H,
           cudaStream_t stream) {
  wkv_chunked_kernel<N, T><<<dim3(H, B), THREADS, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w), u,
      static_cast<T*>(out), state, Tlen, H);
  return dlk_last_error();
}

template <int N>
int by_dtype(int dtype, const void* r, const void* k, const void* v,
             const void* w, const float* u, void* out, float* state, int B,
             int Tlen, int H, cudaStream_t stream) {
  if (dtype == 0)
    return launch<N, float>(r, k, v, w, u, out, state, B, Tlen, H, stream);
  if (dtype == 1)
    return launch<N, __nv_bfloat16>(r, k, v, w, u, out, state, B, Tlen, H,
                                    stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 fp32, 1 bf16 (r, k, v, w and out); u and state are fp32.
extern "C" int dlk_rwkv6_chunked(const void* r, const void* k, const void* v,
                                 const void* w, const float* u, void* out,
                                 float* state, int B, int T, int H, int N,
                                 int dtype, cudaStream_t stream) {
  if (B < 1 || T < 1 || H < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (N == 32)
    return by_dtype<32>(dtype, r, k, v, w, u, out, state, B, T, H, stream);
  if (N == 64)
    return by_dtype<64>(dtype, r, k, v, w, u, out, state, B, T, H, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
