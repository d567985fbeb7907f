// B8 + B9: full-sequence flash attention (prefill, training, cross
// attention) with causal and sliding-window masks and GQA, in fp32 or bf16:
// the forward, with the per-row logsumexp when the backward needs it, and
// the FlashAttention-2 backward (dq, and dk/dv summed over each KV head's
// group).
//
// Replaces repro/kernels/flash_attention.py::flash_attention (B8, body
// _flash_kernel) and repro/kernels/flash_attention_bwd.py (B9: _fwd_kernel,
// _dq_kernel, _dkv_kernel).  On the TPU the grid (B*H, Sq/bq, Sk/bk) walks
// the KV axis in order and carries (m, l, acc) in VMEM scratch from one
// grid step to the next; the inputs are transposed to (B*H, S, D) first,
// Sq and Sk must be multiples of the blocks, and every KV block is visited
// (the mask sets the invisible scores to -1e30).  dk/dv are computed per
// query head and summed over the group outside the kernel.
//
// Bound on the H100: operations.  A 64 x 64 score tile costs 2*64*64*D
// flops for QK^T and as many for PV against 2*64*D*4 bytes of K/V, so the
// kernels sit far above the ridge at S >= 64.  The forward at every head
// dim, and dq and dk/dv up to head dim 128, run every product 3xTF32 on
// the tensor cores (494.7 TFLOP/s TF32, three products each); dq and
// dk/dv at head dim 256 run fp32 FFMA (67 TFLOP/s).  The forward at
// TinyLlama's train shape (4 x 2048, 32/4 heads of 64, causal, fp32:
// 2.69e8 visible pairs, 6.87e10 flops) is bound at 3 x 6.87e10 / 494.7e12
// = 0.417 ms (FFMA: 1.026 ms).
//
// Design, common to all four kernels:
//  - q has Sq rows and k, v have Sk; query positions start at 0, as in the
//    Pallas kernels (query i sees key j when j <= i if causal and
//    j > i - window if windowed);
//  - one CTA per (query tile, head, batch) for the forward and dq, per
//    (key tile, KV head, batch) for dk/dv;
//  - the loop over the other axis is inside the CTA and bounded by the
//    causal and window limits, so a tile that no row can see is never
//    loaded; the ragged edges of Sq and Sk are masked (rows and keys past
//    them are zero-filled, and a key past Sk has p = 0), so nothing is
//    padded;
//  - tiles are read by strides straight from (B, Sq, H, D) / (B, Sk, KV, D)
//    (no transposes), converted to fp32 in shared memory;
//  - 3xTF32: each fp32 operand x is split as x = hi + lo, lo exact in fp32,
//    and the fp32 accumulators sum lo.hi + hi.lo + hi.hi, which keeps fp32
//    accuracy (single-pass TF32 would not hold the fp32 bars).  bf16 data
//    is exact in TF32, so the lo terms of q, k, v and dO are dropped (never
//    those of p and ds, which are fp32);
//  - masking is the reference's arithmetic: a masked score is -1e30, and
//    p = exp(s - m) (forward) or exp(s - lse) (backward).  A row that has
//    seen no visible key yet has m = -1e30 and so p = 1 on its masked keys,
//    which the first visible key's corr = exp(-1e30 - m) = 0 wipes exactly;
//    a row that no key can see (Sq > Sk + window - 1 with a window) keeps
//    p = 1 on every key, so its output is the mean of v and its lse
//    -1e30 + log(Sk) = -1e30 in fp32, as the Pallas kernels give.  A CTA
//    holding such rows visits every key tile (dk/dv: every query tile);
//  - lse = m + log(max(l, 1e-30)), as the reference writes it, so the
//    backward's exp(s - lse) are the forward's probabilities;
//  - no float atomics: two runs are bit-equal.
//
// The forward up to head dim 128 (flash_fwd_tc, FwdTc): wgmma m64nNk8 TF32
// (csrc/sm90.cuh), one warpgroup of 128 threads a CTA and 64 query rows,
// long rows first.  What it does about the four limits of the FFMA forward
// it replaced (2.5 ms at the train shape, 1.11-1.15x SDPA's forward):
//  1. FFMA's 67 TFLOP/s: both products on the tensor cores in 3xTF32, hi
//     = rna(x) (K's written back over its landed tile).  The tensor core
//     truncates its running sum at every step, so each product's small
//     terms are issued first, its hi.hi terms are spread over several
//     accumulators added in fp32, and each tile's p.V is summed apart and
//     added to o in fp32 (o's error against fp64 at or under FFMA's:
//     benchmarks/flash_fwd_variants.cu);
//  2. synchronous K/V loads: a ring of 2-3 stages filled by cp.async (16
//     bytes, zero-fill past Sk), the next tiles' copies in flight during
//     this tile's products; a pass over the landed tile writes K's lo and
//     V's hi and lo transposed (TF32 wgmma reads K-major operands only);
//  3. probabilities through shared memory: p stays in the score
//     accumulator's registers and is p.V's A operand, V^T's keys stored in
//     each group of 8 in the order (0, 2, 4, 6, 1, 3, 5, 7) to match the
//     accumulator's columns (a product's depth order is free);
//  4. row statistics over 16 lanes: a thread holds two whole-row slices,
//     and a row's max and sum take 2 shuffles within its quad.
// At head dim 256 the forward is flash_fwd_tc256 (FwdTc256, below): two
// warpgroups that split q.k^T and o by head-dim halves, o accumulated
// transposed with V as the register operand.  It replaced an FFMA forward
// on the tiles below (benchmarks/flash_fwd_variants.cu keeps that one, at
// head dim 64, as its yardstick).
//
// The FFMA kernels (dq and dk/dv at head dim 256): 32 query and 32 key
// rows a tile (Tiles<256>), 256 threads; thread (ty, tx) of a
// 16 x 16 grid owns rows ty + 16 i and score columns tx + 16 j of a score
// tile, and D / 16 output columns of its rows (4 tx + 64 j + e), so the
// row statistics of the online softmax stay in its registers and are
// reduced over 16 lanes by shuffles; products read float4 rows of padded
// shared tiles; the probabilities pass through shared memory.
//
// The tensor-core backward (dq, dk/dv up to D 128): every product (q.k^T,
// dO.v^T, ds.k in dq; k.q^T, v.dO^T, p^T.dO, ds^T.q in dk/dv) runs on
// mma.sync m16n8k8 TF32 as 3xTF32, hi = rna(x) (to nearest, ties away) and
// lo = x - hi, which the tensor core truncates.  Warp w of 8 owns a
// 16-row band (w % 4) of the CTA's tile and half w / 4 of the score
// columns, then half w / 4 of D; the probabilities (ds; p^T and ds^T) pass
// through shared memory between the two steps.  Tiles: TcTiles<D>; D-wide
// tiles have stride D + 8 and probability tiles their width + 4, and the
// fragment loads are laid out so that no load hits a bank twice: tiles
// read along their rows pair depth 2t, 2t + 1 into one 8-byte load (mma's
// k slots t, t + 4), tiles read down their columns (k in dq; q and dO in
// dk/dv) are read as mma lays them out.  The streamed tiles (dq: K and V;
// dk/dv: Q and dO with their lse and dsum rows) go by cp.async (bf16:
// converted on the way by plain loads); up to D 64 they have one stage and
// two CTAs share an SM, at D 128 one CTA has the SM and they are
// double-buffered.  dk/dv: one CTA per key tile loops over the G query
// heads of its KV head and over the query tiles that can see it,
// accumulating dk and dv in fp32 registers (each tile's products summed
// apart, then added; dq likewise per key tile), and writes the group sum
// once (the reference's per-head outputs and their sum over G are never
// stored).
//
// Not yet done: the backward on wgmma (the forward's sm90.cuh pieces),
// and dq and dk/dv at head dim 256 on the tensor cores (no model trains at
// head dim 256 at full width).
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "sm90.cuh"

namespace {

constexpr int THREADS = 256;       // a 16 x 16 grid
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

// Query and key rows per tile for head dim D.
template <int D>
struct Tiles {
  static constexpr int Q = D <= 128 ? 64 : 32;
  static constexpr int K = D <= 128 ? 64 : 32;
};

struct Shape {
  int Sq, Sk, H, KV, G;            // query and key lengths, heads, H / KV
  int causal, window;
  float scale;
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void st4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ void st4(__nv_bfloat16* p, float4 x) {
  __nv_bfloat162 a = __floats2bfloat162_rn(x.x, x.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(x.z, x.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&a);
  u.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}
__device__ __forceinline__ void st2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void st2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}
__device__ __forceinline__ void st1(float* p, float x) { *p = x; }
__device__ __forceinline__ void st1(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// The D / 16 output columns that thread tx owns in a row of D (the FFMA
// kernels: head dim 256, or 64 in benchmarks/flash_fwd_variants.cu):
// float4 groups 4 tx + 64 j + e (e < 4).
template <int D>
__device__ __forceinline__ void ld_cols(float (&x)[D / 16], const float* row,
                                        int tx) {
  static_assert(D % 64 == 0, "the FFMA kernels take head dims 64 and 256");
#pragma unroll
  for (int j = 0; j < D / 64; ++j) {
    const float4 a = ld4(row + 4 * tx + 64 * j);
    x[4 * j + 0] = a.x;
    x[4 * j + 1] = a.y;
    x[4 * j + 2] = a.z;
    x[4 * j + 3] = a.w;
  }
}
template <int D, typename T>
__device__ __forceinline__ void st_cols(T* row, const float (&x)[D / 16],
                                        int tx) {
#pragma unroll
  for (int j = 0; j < D / 64; ++j)
    st4(row + 4 * tx + 64 * j,
        make_float4(x[4 * j], x[4 * j + 1], x[4 * j + 2], x[4 * j + 3]));
}

// The reference's mask of query position qp against key position kp.
__device__ __forceinline__ bool visible(const Shape& sh, int qp, int kp) {
  return (!sh.causal || kp <= qp) && (!sh.window || kp > qp - sh.window);
}

// Every query row of [q0, q0 + QR) sees every key of [k0, k0 + KR), all
// of them before Sk: the tile needs no mask.
template <int QR, int KR>
__device__ __forceinline__ bool tile_visible(const Shape& sh, int q0, int k0) {
  return (!sh.causal || k0 + KR - 1 <= q0) &&
         (!sh.window || k0 > q0 + QR - 1 - sh.window) && k0 + KR <= sh.Sk;
}

// Query rows from this position on see no key (only with a window).
__device__ __forceinline__ int first_blind_row(const Shape& sh) {
  return sh.window ? sh.Sk + sh.window - 1 : INT32_MAX;
}

// A tile-aligned first key and the key bound that the query rows
// [q0, q0 + QR) can see: nothing outside [lo, hi) is visited.  Rows that
// see no key take every key, as the reference does.
template <int QR, int KR>
__device__ __forceinline__ void key_range(const Shape& sh, int q0, int& lo,
                                          int& hi) {
  const int q_last = min(q0 + QR, sh.Sq) - 1;
  if (q_last >= first_blind_row(sh)) {
    lo = 0;
    hi = sh.Sk;
    return;
  }
  hi = sh.causal ? min(q_last + 1, sh.Sk) : sh.Sk;
  lo = sh.window ? max(0, q0 - sh.window + 1) : 0;
  lo = (lo / KR) * KR;
}

// ROWS rows of D elements, row r at src + r * row_stride, into a shared
// tile of stride D + 4 as fp32; rows at or past `rows` are zero.
template <int D, int ROWS, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          long long row_stride, int rows) {
  constexpr int V = D / 4, STR = D + 4;
#pragma unroll 4
  for (int i = threadIdx.x; i < ROWS * V; i += THREADS) {
    const int r = i / V, c = (i % V) * 4;
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (r < rows) x = ld4(src + r * row_stride + c);
    st4(dst + r * STR + c, x);
  }
}

// acc[i][j] = sum_d A[ty + 16 i][d] * B[tx + 16 j][d] over two shared tiles
// of stride D + 4.
template <int D, int NI, int NJ>
__device__ __forceinline__ void dot_tile(float (&acc)[NI][NJ], const float* A,
                                         const float* B, int ty, int tx) {
  constexpr int STR = D + 4;
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 a[NI], b[NJ];
#pragma unroll
    for (int i = 0; i < NI; ++i) a[i] = ld4(A + (ty + 16 * i) * STR + d);
#pragma unroll
    for (int j = 0; j < NJ; ++j) b[j] = ld4(B + (tx + 16 * j) * STR + d);
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
        acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
        acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
        acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
      }
  }
}

// acc[i][e] += sum_c P[ty + 16 i][c] * M[c][column e of tx] over c < NC: a
// tile of stride NC + 4 times an NC-row tile of stride D + 4.
template <int D, int NI, int NC>
__device__ __forceinline__ void pm_tile(float (&acc)[NI][D / 16], const float* P,
                                        const float* M, int ty, int tx) {
  constexpr int STR = D + 4, PS = NC + 4;
#pragma unroll 2
  for (int c = 0; c < NC; c += 4) {
    float4 p[NI];
#pragma unroll
    for (int i = 0; i < NI; ++i) p[i] = ld4(P + (ty + 16 * i) * PS + c);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      float m[D / 16];
      ld_cols<D>(m, M + (c + cc) * STR, tx);
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        const float pc = cc == 0 ? p[i].x : cc == 1 ? p[i].y
                       : cc == 2 ? p[i].z : p[i].w;
#pragma unroll
        for (int e = 0; e < D / 16; ++e) acc[i][e] = fmaf(pc, m[e], acc[i][e]);
      }
    }
  }
}

// acc += P M (pm_tile) through the zeroed scratch `part`.
template <int D, int NI, int NC>
__device__ __forceinline__ void add_tile(float (&acc)[NI][D / 16],
                                         float (&part)[NI][D / 16],
                                         const float* P, const float* M,
                                         int ty, int tx) {
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int e = 0; e < D / 16; ++e) part[i][e] = 0.0f;
  pm_tile<D, NI, NC>(part, P, M, ty, tx);
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int e = 0; e < D / 16; ++e) acc[i][e] += part[i][e];
}

__device__ __forceinline__ float max16(float x) {
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}
__device__ __forceinline__ float sum16(float x) {
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

// Row r of the accumulator acc[i] is row ty + 16 i of a tile; writes
// acc / div (div = 1 when null) as T at dst + r * row_stride for r < rows.
template <int D, int NI, typename T>
__device__ __forceinline__ void store_rows(T* dst, long long row_stride,
                                           int rows, const float (&acc)[NI][D / 16],
                                           const float* div, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int r = ty + 16 * i;
    if (r >= rows) continue;
    float x[D / 16];
#pragma unroll
    for (int e = 0; e < D / 16; ++e) x[e] = div ? acc[i][e] / div[i] : acc[i][e];
    st_cols<D>(dst + r * row_stride, x, tx);
  }
}

// ---------------------------------------------------------------------------
// dq (B, Sq, H, D): sum over the keys of ds k, ds = p (dO v^T - dsum) scale
// ---------------------------------------------------------------------------

template <int D, typename T>
__global__ void __launch_bounds__(THREADS)
flash_dq(const T* __restrict__ q, const T* __restrict__ k,
         const T* __restrict__ v, const T* __restrict__ dout,
         const float* __restrict__ lse, const float* __restrict__ dsum,
         T* __restrict__ dq, Shape sh) {
  constexpr int QR = Tiles<D>::Q, KR = Tiles<D>::K;
  constexpr int NI = QR / 16, NJ = KR / 16, STR = D + 4, PS = KR + 4;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);   // QR x STR
  float* do_s = q_s + QR * STR;                   // QR x STR
  float* k_s = do_s + QR * STR;                   // KR x STR
  float* v_s = k_s + KR * STR;                    // KR x STR
  float* ds_s = v_s + KR * STR;                   // QR x PS
  const int nq = (sh.Sq + QR - 1) / QR;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * QR;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / sh.G;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const long long qrow = static_cast<long long>(sh.H) * D;
  const long long krow = static_cast<long long>(sh.KV) * D;
  const long long qoff = (static_cast<long long>(b) * sh.Sq + q0) * qrow + h * D;
  const long long kbase = static_cast<long long>(b) * sh.Sk * krow + kvh * D;
  const long long row0 = (static_cast<long long>(b) * sh.H + h) * sh.Sq + q0;
  load_tile<D, QR>(q_s, q + qoff, qrow, sh.Sq - q0);
  load_tile<D, QR>(do_s, dout + qoff, qrow, sh.Sq - q0);
  float lse_r[NI], dsum_r[NI], acc[NI][D / 16];
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const bool in = q0 + ty + 16 * i < sh.Sq;
    lse_r[i] = in ? lse[row0 + ty + 16 * i] : 0.0f;
    dsum_r[i] = in ? dsum[row0 + ty + 16 * i] : 0.0f;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc[i][c] = 0.0f;
  }
  int lo, hi;
  key_range<QR, KR>(sh, q0, lo, hi);
  for (int k0 = lo; k0 < hi; k0 += KR) {
    __syncthreads();
    load_tile<D, KR>(k_s, k + kbase + k0 * krow, krow, sh.Sk - k0);
    load_tile<D, KR>(v_s, v + kbase + k0 * krow, krow, sh.Sk - k0);
    __syncthreads();
    float s[NI][NJ], dp[NI][NJ];
    dot_tile<D, NI, NJ>(s, q_s, k_s, ty, tx);
    dot_tile<D, NI, NJ>(dp, do_s, v_s, ty, tx);
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int qp = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int kp = k0 + tx + 16 * j;
        const float sv = visible(sh, qp, kp) ? s[i][j] * sh.scale : NEG_INF;
        const float p = kp < sh.Sk ? expf(sv - lse_r[i]) : 0.0f;
        ds_s[(ty + 16 * i) * PS + tx + 16 * j] =
            p * (dp[i][j] - dsum_r[i]) * sh.scale;
      }
    }
    __syncthreads();
    pm_tile<D, NI, KR>(acc, ds_s, k_s, ty, tx);
  }
  store_rows<D, NI>(dq + qoff, qrow, sh.Sq - q0, acc, nullptr, ty, tx);
}

// ---------------------------------------------------------------------------
// dk, dv (B, Sk, KV, D): per key tile, summed over the G query heads of its
// KV head and the query rows that see it
// ---------------------------------------------------------------------------

template <int D, typename T>
__global__ void __launch_bounds__(THREADS)
flash_dkv(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ dsum,
          T* __restrict__ dk, T* __restrict__ dv, Shape sh) {
  constexpr int QR = Tiles<D>::Q, KR = Tiles<D>::K;
  constexpr int NI = KR / 16, NJ = QR / 16, STR = D + 4, PS = QR + 4;
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);   // KR x STR
  float* v_s = k_s + KR * STR;                    // KR x STR
  float* q_s = v_s + KR * STR;                    // QR x STR
  float* do_s = q_s + QR * STR;                   // QR x STR
  float* pt_s = do_s + QR * STR;                  // KR x PS: p^T
  float* dst_s = pt_s + KR * PS;                  // KR x PS: ds^T
  float* lse_s = dst_s + KR * PS;                 // QR
  float* dsum_s = lse_s + QR;                     // QR
  const int k0 = blockIdx.x * KR, kvh = blockIdx.y, b = blockIdx.z;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const long long qrow = static_cast<long long>(sh.H) * D;
  const long long krow = static_cast<long long>(sh.KV) * D;
  const long long koff = (static_cast<long long>(b) * sh.Sk + k0) * krow + kvh * D;
  load_tile<D, KR>(k_s, k + koff, krow, sh.Sk - k0);
  load_tile<D, KR>(v_s, v + koff, krow, sh.Sk - k0);
  // the query rows that can see a key of [k0, k_last], and the rows that
  // see no key (they take every key, as in the reference)
  const int k_last = min(k0 + KR, sh.Sk) - 1;
  const int q_lo = sh.causal ? (k0 / QR) * QR : 0;
  const int q_hi = sh.Sq > first_blind_row(sh) ? sh.Sq
                 : sh.window ? min(sh.Sq, k_last + sh.window) : sh.Sq;

  float dk_acc[NI][D / 16], dv_acc[NI][D / 16];
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.0f;
  for (int g = 0; g < sh.G; ++g) {
    const int h = kvh * sh.G + g;
    for (int q0 = q_lo; q0 < q_hi; q0 += QR) {
      __syncthreads();
      const long long qoff = (static_cast<long long>(b) * sh.Sq + q0) * qrow + h * D;
      load_tile<D, QR>(q_s, q + qoff, qrow, sh.Sq - q0);
      load_tile<D, QR>(do_s, dout + qoff, qrow, sh.Sq - q0);
      if (threadIdx.x < QR) {
        const int r = threadIdx.x;
        const long long row = (static_cast<long long>(b) * sh.H + h) * sh.Sq + q0 + r;
        const bool in = q0 + r < sh.Sq;
        lse_s[r] = in ? lse[row] : 0.0f;
        dsum_s[r] = in ? dsum[row] : 0.0f;
      }
      __syncthreads();
      float s[NI][NJ], dp[NI][NJ];      // [key ty + 16 i][query tx + 16 j]
      dot_tile<D, NI, NJ>(s, k_s, q_s, ty, tx);
      dot_tile<D, NI, NJ>(dp, v_s, do_s, ty, tx);
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        const int kp = k0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int r = tx + 16 * j;
          const bool in = kp < sh.Sk && q0 + r < sh.Sq;
          const float sv = visible(sh, q0 + r, kp) ? s[i][j] * sh.scale : NEG_INF;
          const float p = in ? expf(sv - lse_s[r]) : 0.0f;
          pt_s[(ty + 16 * i) * PS + r] = p;
          dst_s[(ty + 16 * i) * PS + r] = p * (dp[i][j] - dsum_s[r]) * sh.scale;
        }
      }
      __syncthreads();
      // each tile's products are summed apart, then added: a key that many
      // rows see (a GQA group, rows that see every key) sums blockwise,
      // not in one fp32 chain G * Sq long
      float part[NI][D / 16];
      add_tile<D, NI, QR>(dv_acc, part, pt_s, do_s, ty, tx);
      add_tile<D, NI, QR>(dk_acc, part, dst_s, q_s, ty, tx);
    }
  }
  store_rows<D, NI>(dk + koff, krow, sh.Sk - k0, dk_acc, nullptr, ty, tx);
  store_rows<D, NI>(dv + koff, krow, sh.Sk - k0, dv_acc, nullptr, ty, tx);
}

// ---------------------------------------------------------------------------
// The backward on the tensor cores (head dims 32, 64, 128): every product
// in 3xTF32 on mma.sync m16n8k8
// ---------------------------------------------------------------------------

// The tensor-core backward's tiles: dq takes 64 query rows a CTA and
// streams 64-key tiles; dk/dv takes 64 key rows a CTA and streams query
// tiles of 64 rows (32 at D 128, to fit shared memory).  A warp owns MT
// 16-row bands of the CTA's 64 rows and half of the columns: up to D 64,
// MT = 2 and 4 warps a CTA, two CTAs an SM, a streamed tile in one stage
// (so that one CTA's loads and barriers overlap the other's products, and
// a 32 x 32 warp tile splits each operand element for fewer warps); at D
// 128, MT = 1 and 8 warps, one CTA an SM, the streamed tiles
// double-buffered (the accumulators of a 32-row band would not fit the
// registers).  A D-wide tile has row stride D + 8 (8 mod 32) and a
// probability tile its width + 4 (4 mod 32): with the fragment loads
// below no load hits a bank twice.
template <int D>
struct TcTiles {
  static constexpr int DQ_Q = 64, DQ_K = 64, DKV_K = 64;
  static constexpr int DKV_Q = D <= 64 ? 64 : 32;
  static constexpr int STR = D + 8;
  static constexpr int MT = D <= 64 ? 2 : 1;           // 16-row bands a warp
  static constexpr int BANDS = 4 / MT;                 // warps along the rows
  static constexpr int THREADS = 32 * 2 * BANDS;       // two column halves
  static constexpr int STAGES = D <= 64 ? 1 : 2;
  static constexpr int CTAS_PER_SM = D <= 64 ? 2 : 1;
};

// Fragments (g = lane / 4, t = lane % 4).  For a product whose depth runs
// along both tiles' rows (q.k^T, dO.v^T and their transposes) the
// fragments pair depth d0 + 2t and d0 + 2t + 1 in mma's k slots t and
// t + 4 (a product's depth order is free), so a row's pair is one 8-byte
// load: with stride 8 mod 32 a half-warp's 16 loads cover 32 banks.
template <int STR>
__device__ __forceinline__ Frag<4> frag_a_pairs(const float* tile, int r0,
                                                int d0, int g, int t) {
  const float2 x = *reinterpret_cast<const float2*>(tile + (r0 + g) * STR + d0 + 2 * t);
  const float2 y = *reinterpret_cast<const float2*>(tile + (r0 + g + 8) * STR + d0 + 2 * t);
  Frag<4> f;
  split(f, 0, x.x);
  split(f, 1, y.x);
  split(f, 2, x.y);
  split(f, 3, y.y);
  return f;
}
// B's column n is tile row r0 + n.
template <int STR>
__device__ __forceinline__ Frag<2> frag_b_pairs(const float* tile, int r0,
                                                int d0, int g, int t) {
  const float2 x = *reinterpret_cast<const float2*>(tile + (r0 + g) * STR + d0 + 2 * t);
  Frag<2> f;
  split(f, 0, x.x);
  split(f, 1, x.y);
  return f;
}
// For P M (ds.k in dq; p^T dO and ds^T q in dk/dv): A is rows r0 + g,
// r0 + g + 8 and columns k0 + t, k0 + t + 4 of a probability tile of
// stride PS (4 mod 32: 32 banks), as mma lays it out ...
template <int PS>
__device__ __forceinline__ Frag<4> frag_a(const float* tile, int r0, int k0,
                                          int g, int t) {
  const float* p = tile + (r0 + g) * PS + k0 + t;
  Frag<4> f;
  split(f, 0, p[0]);
  split(f, 1, p[8 * PS]);
  split(f, 2, p[4]);
  split(f, 3, p[8 * PS + 4]);
  return f;
}
// ... and B is rows k0 + t, k0 + t + 4, column n0 + g of a D-wide tile
// read down its columns (stride 8 mod 32: 32 banks).
template <int STR>
__device__ __forceinline__ Frag<2> frag_b_down(const float* tile, int k0,
                                               int n0, int g, int t) {
  const float* p = tile + (k0 + t) * STR + n0 + g;
  Frag<2> f;
  split(f, 0, p[0]);
  split(f, 1, p[4 * STR]);
  return f;
}

// s = A1 B1^T and dp = A2 B2^T over depth D for the warp's MT 16-row
// bands r0 + 16 m of A1, A2 against NT 8-row groups c0 + 8 j of B1, B2
// (all D-wide tiles).
template <int D, int STR, int MT, int NT, bool EX>
__device__ __forceinline__ void score_tiles(float (&s)[MT][NT][4],
                                            float (&dp)[MT][NT][4],
                                            const float* a1, const float* b1,
                                            const float* a2, const float* b2,
                                            int r0, int c0, int g, int t) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[m][j][e] = dp[m][j][e] = 0.0f;
#pragma unroll 2
  for (int d0 = 0; d0 < D; d0 += 8) {
    Frag<4> x[MT], y[MT];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      x[m] = frag_a_pairs<STR>(a1, r0 + 16 * m, d0, g, t);
      y[m] = frag_a_pairs<STR>(a2, r0 + 16 * m, d0, g, t);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const Frag<2> u = frag_b_pairs<STR>(b1, c0 + 8 * j, d0, g, t);
      const Frag<2> w = frag_b_pairs<STR>(b2, c0 + 8 * j, d0, g, t);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        mma3<EX, EX>(s[m][j], x[m], u);
        mma3<EX, EX>(dp[m][j], y[m], w);
      }
    }
  }
}

// acc += P M for the warp's MT bands r0 + 16 m of a probability tile P
// (KC wide, stride PS) and ND 8-column groups c0 + 8 j of a KC-row tile M:
// the tile's products summed apart, then added.
template <int KC, int PS, int STR, int MT, int ND, bool EX>
__device__ __forceinline__ void add_pm(float (&acc)[MT][ND][4], const float* p,
                                       const float* m, int r0, int c0, int g,
                                       int t) {
  float part[MT][ND][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < ND; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[i][j][e] = 0.0f;
#pragma unroll 2
  for (int k0 = 0; k0 < KC; k0 += 8) {
    Frag<4> a[MT];
#pragma unroll
    for (int i = 0; i < MT; ++i) a[i] = frag_a<PS>(p, r0 + 16 * i, k0, g, t);
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      const Frag<2> b = frag_b_down<STR>(m, k0, c0 + 8 * j, g, t);
#pragma unroll
      for (int i = 0; i < MT; ++i) mma3<false, EX>(part[i][j], a[i], b);
    }
  }
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < ND; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
}

// ROWS rows of D elements (row r at src + r * row_stride) into a shared
// fp32 tile of stride STR, by a CTA of NTHR threads, rows at or past
// `rows` zero: fp32 by cp.async (the caller commits and waits), bf16
// converted on the way by plain loads.
template <int D, int ROWS, int STR, int NTHR, typename T>
__device__ __forceinline__ void stage_tile(float* dst, const T* __restrict__ src,
                                           long long row_stride, int rows) {
  constexpr int V = D / 4;
#pragma unroll 4
  for (int i = threadIdx.x; i < ROWS * V; i += NTHR) {
    const int r = i / V, c = (i % V) * 4;
    const bool ok = r < rows;
    if constexpr (std::is_same<T, float>::value) {
      dlk_cp_async16(dst + r * STR + c, ok ? src + r * row_stride + c : src, ok);
    } else {
      float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (ok) x = ld4(src + r * row_stride + c);
      st4(dst + r * STR + c, x);
    }
  }
}

// The warp's accumulator (rows r0 + 16 m + g, + 8; columns c0 + 8 j + 2t,
// + 1) stored as T at dst + r * row_stride for r < rows.
template <int MT, int ND, typename T>
__device__ __forceinline__ void store_frags(T* dst, long long row_stride,
                                            int rows,
                                            const float (&acc)[MT][ND][4],
                                            int r0, int c0, int g, int t) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + 16 * m + g + 8 * i;
      if (r >= rows) continue;
#pragma unroll
      for (int j = 0; j < ND; ++j)
        st2(dst + r * row_stride + c0 + 8 * j + 2 * t, acc[m][j][2 * i],
            acc[m][j][2 * i + 1]);
    }
}

// dq on the tensor cores: warp w owns the MT bands of query rows from
// r0 = 16 MT (w % BANDS); in the score step it takes half w / BANDS of the
// key tile, in the accumulation step half w / BANDS of D.  The K and V
// tiles stream in TL::STAGES stages.
template <int D, typename T>
__global__ void __launch_bounds__(TcTiles<D>::THREADS, TcTiles<D>::CTAS_PER_SM)
flash_dq_tc(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ dsum,
            T* __restrict__ dq, Shape sh) {
  using TL = TcTiles<D>;
  constexpr int QR = TL::DQ_Q, KR = TL::DQ_K, STR = TL::STR, PS = KR + 4;
  constexpr int MT = TL::MT, NS = TL::STAGES, NTHR = TL::THREADS;
  constexpr int NT = KR / 16, ND = D / 16;
  constexpr bool EX = !std::is_same<T, float>::value;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);   // QR x STR
  float* do_s = q_s + QR * STR;                   // QR x STR
  float* k_s = do_s + QR * STR;                   // NS stages of KR x STR
  float* v_s = k_s + NS * KR * STR;               // NS stages of KR x STR
  float* ds_s = v_s + NS * KR * STR;              // QR x PS
  const int nq = (sh.Sq + QR - 1) / QR;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * QR;  // long rows first
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / sh.G;
  const int warp = threadIdx.x / 32, g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const int r0 = 16 * MT * (warp % TL::BANDS), half = warp / TL::BANDS;
  const long long qrow = static_cast<long long>(sh.H) * D;
  const long long krow = static_cast<long long>(sh.KV) * D;
  const long long qoff = (static_cast<long long>(b) * sh.Sq + q0) * qrow + h * D;
  const long long kbase = static_cast<long long>(b) * sh.Sk * krow + kvh * D;
  const long long row0 = (static_cast<long long>(b) * sh.H + h) * sh.Sq + q0;
  int lo, hi;
  key_range<QR, KR>(sh, q0, lo, hi);
  stage_tile<D, QR, STR, NTHR>(q_s, q + qoff, qrow, sh.Sq - q0);
  stage_tile<D, QR, STR, NTHR>(do_s, dout + qoff, qrow, sh.Sq - q0);
  if (lo < hi) {
    stage_tile<D, KR, STR, NTHR>(k_s, k + kbase + lo * krow, krow, sh.Sk - lo);
    stage_tile<D, KR, STR, NTHR>(v_s, v + kbase + lo * krow, krow, sh.Sk - lo);
  }
  dlk_cp_async_commit();
  float lse_r[MT][2], dsum_r[MT][2], acc[MT][ND][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + 16 * m + g + 8 * i;
      const bool in = q0 + r < sh.Sq;
      lse_r[m][i] = in ? lse[row0 + r] : 0.0f;
      dsum_r[m][i] = in ? dsum[row0 + r] : 0.0f;
#pragma unroll
      for (int j = 0; j < ND; ++j) acc[m][j][2 * i] = acc[m][j][2 * i + 1] = 0.0f;
    }
  int st = 0;
  for (int k0 = lo; k0 < hi; k0 += KR, st = NS == 2 ? st ^ 1 : 0) {
    dlk_cp_async_wait<0>();
    __syncthreads();   // tile k0 is in; the previous tile and ds_s are consumed
    if (NS == 2 && k0 + KR < hi) {
      const long long next = kbase + (k0 + KR) * krow;
      stage_tile<D, KR, STR, NTHR>(k_s + (st ^ 1) * KR * STR, k + next, krow,
                                   sh.Sk - k0 - KR);
      stage_tile<D, KR, STR, NTHR>(v_s + (st ^ 1) * KR * STR, v + next, krow,
                                   sh.Sk - k0 - KR);
    }
    dlk_cp_async_commit();
    const float* kt = k_s + st * KR * STR;
    const float* vt = v_s + st * KR * STR;
    float s[MT][NT][4], dp[MT][NT][4];
    score_tiles<D, STR, MT, NT, EX>(s, dp, q_s, kt, do_s, vt, r0,
                                    half * (KR / 2), g, t);
    const bool full = tile_visible<QR, KR>(sh, q0, k0);
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = r0 + 16 * m + g + 8 * i;
          const int c = half * (KR / 2) + 8 * j + 2 * t;
          float ds[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kp = k0 + c + e;
            const float sv = full || visible(sh, q0 + r, kp)
                                 ? s[m][j][2 * i + e] * sh.scale : NEG_INF;
            const float p = full || kp < sh.Sk ? expf(sv - lse_r[m][i]) : 0.0f;
            ds[e] = p * (dp[m][j][2 * i + e] - dsum_r[m][i]) * sh.scale;
          }
          st2(ds_s + r * PS + c, ds[0], ds[1]);
        }
    __syncthreads();
    add_pm<KR, PS, STR, MT, ND, EX>(acc, ds_s, kt, r0, half * (D / 2), g, t);
    if (NS == 1 && k0 + KR < hi) {
      __syncthreads();
      const long long next = kbase + (k0 + KR) * krow;
      stage_tile<D, KR, STR, NTHR>(k_s, k + next, krow, sh.Sk - k0 - KR);
      stage_tile<D, KR, STR, NTHR>(v_s, v + next, krow, sh.Sk - k0 - KR);
      dlk_cp_async_commit();
    }
  }
  store_frags<MT, ND>(dq + qoff, qrow, sh.Sq - q0, acc, r0, half * (D / 2), g, t);
}

// dk, dv on the tensor cores: warp w owns the MT bands of key rows from
// r0 = 16 MT (w % BANDS); in the score step it takes half w / BANDS of the
// query tile, in the accumulation steps half w / BANDS of D.  The Q and dO
// tiles, with their lse and dsum rows, stream in TL::STAGES stages over
// the (query head, query tile) steps.
template <int D, typename T>
__global__ void __launch_bounds__(TcTiles<D>::THREADS, TcTiles<D>::CTAS_PER_SM)
flash_dkv_tc(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ dsum,
             T* __restrict__ dk, T* __restrict__ dv, Shape sh) {
  using TL = TcTiles<D>;
  constexpr int KR = TL::DKV_K, QR = TL::DKV_Q, STR = TL::STR, PS = QR + 4;
  constexpr int MT = TL::MT, NS = TL::STAGES, NTHR = TL::THREADS;
  constexpr int NT = QR / 16, ND = D / 16;
  constexpr bool EX = !std::is_same<T, float>::value;
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);   // KR x STR
  float* v_s = k_s + KR * STR;                    // KR x STR
  float* q_s = v_s + KR * STR;                    // NS stages of QR x STR
  float* do_s = q_s + NS * QR * STR;              // NS stages of QR x STR
  float* pt_s = do_s + NS * QR * STR;             // KR x PS: p^T
  float* dst_s = pt_s + KR * PS;                  // KR x PS: ds^T
  float* lse_s = dst_s + KR * PS;                 // NS stages of QR
  float* dsum_s = lse_s + NS * QR;                // NS stages of QR
  const int k0 = blockIdx.x * KR, kvh = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const int r0 = 16 * MT * (warp % TL::BANDS), half = warp / TL::BANDS;
  const long long qrow = static_cast<long long>(sh.H) * D;
  const long long krow = static_cast<long long>(sh.KV) * D;
  const long long koff = (static_cast<long long>(b) * sh.Sk + k0) * krow + kvh * D;
  stage_tile<D, KR, STR, NTHR>(k_s, k + koff, krow, sh.Sk - k0);
  stage_tile<D, KR, STR, NTHR>(v_s, v + koff, krow, sh.Sk - k0);
  // the query rows that can see a key of [k0, k_last], and the rows that
  // see no key (they take every key, as in the reference)
  const int k_last = min(k0 + KR, sh.Sk) - 1;
  const int q_lo = sh.causal ? (k0 / QR) * QR : 0;
  const int q_hi = sh.Sq > first_blind_row(sh) ? sh.Sq
                 : sh.window ? min(sh.Sq, k_last + sh.window) : sh.Sq;
  const int nq = q_hi > q_lo ? (q_hi - q_lo + QR - 1) / QR : 0;
  const int steps = sh.G * nq;
  // step i: query head kvh * G + i / nq, query tile q_lo + (i % nq) * QR
  auto stage_step = [&](int i, int buf) {
    const int h = kvh * sh.G + i / nq, q0 = q_lo + (i % nq) * QR;
    const long long qoff = (static_cast<long long>(b) * sh.Sq + q0) * qrow + h * D;
    stage_tile<D, QR, STR, NTHR>(q_s + buf * QR * STR, q + qoff, qrow, sh.Sq - q0);
    stage_tile<D, QR, STR, NTHR>(do_s + buf * QR * STR, dout + qoff, qrow,
                                 sh.Sq - q0);
    if (threadIdx.x < QR) {
      const int r = threadIdx.x;
      const long long row = (static_cast<long long>(b) * sh.H + h) * sh.Sq + q0 + r;
      const bool in = q0 + r < sh.Sq;
      dlk_cp_async4(lse_s + buf * QR + r, in ? lse + row : lse, in);
      dlk_cp_async4(dsum_s + buf * QR + r, in ? dsum + row : dsum, in);
    }
  };
  if (steps > 0) stage_step(0, 0);
  dlk_cp_async_commit();

  float dk_acc[MT][ND][4], dv_acc[MT][ND][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < ND; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk_acc[m][j][e] = dv_acc[m][j][e] = 0.0f;
  for (int i = 0; i < steps; ++i) {
    const int buf = NS == 2 ? i & 1 : 0;
    dlk_cp_async_wait<0>();
    __syncthreads();   // step i is in; step i - 1's tiles, p^T and ds^T are consumed
    if (NS == 2 && i + 1 < steps) stage_step(i + 1, buf ^ 1);
    dlk_cp_async_commit();
    const int q0 = q_lo + (i % nq) * QR;
    const float* qt = q_s + buf * QR * STR;
    const float* dot = do_s + buf * QR * STR;
    const float* ls = lse_s + buf * QR;
    const float* dsm = dsum_s + buf * QR;
    float s[MT][NT][4], dp[MT][NT][4];   // [key row][query column]
    score_tiles<D, STR, MT, NT, EX>(s, dp, k_s, qt, v_s, dot, r0,
                                    half * (QR / 2), g, t);
    const bool full = tile_visible<QR, KR>(sh, q0, k0) && q0 + QR <= sh.Sq;
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int ii = 0; ii < 2; ++ii) {
          const int r = r0 + 16 * m + g + 8 * ii, kp = k0 + r;
          const int c = half * (QR / 2) + 8 * j + 2 * t;
          float p[2], ds[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int qc = c + e;
            const bool in = full || (kp < sh.Sk && q0 + qc < sh.Sq);
            const float sv = full || visible(sh, q0 + qc, kp)
                                 ? s[m][j][2 * ii + e] * sh.scale : NEG_INF;
            p[e] = in ? expf(sv - ls[qc]) : 0.0f;
            ds[e] = p[e] * (dp[m][j][2 * ii + e] - dsm[qc]) * sh.scale;
          }
          st2(pt_s + r * PS + c, p[0], p[1]);
          st2(dst_s + r * PS + c, ds[0], ds[1]);
        }
    __syncthreads();
    // each step's products summed apart, then added: a key that many
    // rows see (a GQA group, rows that see every key) sums blockwise
    add_pm<QR, PS, STR, MT, ND, EX>(dv_acc, pt_s, dot, r0, half * (D / 2), g, t);
    add_pm<QR, PS, STR, MT, ND, EX>(dk_acc, dst_s, qt, r0, half * (D / 2), g, t);
    if (NS == 1 && i + 1 < steps) {
      __syncthreads();
      stage_step(i + 1, 0);
      dlk_cp_async_commit();
    }
  }
  store_frags<MT, ND>(dk + koff, krow, sh.Sk - k0, dk_acc, r0, half * (D / 2), g, t);
  store_frags<MT, ND>(dv + koff, krow, sh.Sk - k0, dv_acc, r0, half * (D / 2), g, t);
}

// ---------------------------------------------------------------------------
// The forward on the warpgroup tensor cores (head dims 32, 64, 128): both
// products in 3xTF32 on wgmma m64nNk8
// ---------------------------------------------------------------------------

// One warpgroup of 128 threads a CTA owns 64 query rows (warp w rows 16 w
// .. 16 w + 15, a thread rows g and g + 8 of them) and streams key tiles of
// KR rows through a ring of NS stages filled by cp.async.  Shared memory
// (the wgmma operands in Sm90Swizzle128's 128-byte swizzle; the
// no-swizzle layout took 1.16-1.22x as long at the train shape, PERF.md):
//  - ring: NS stages of a K tile and a V tile as they are in memory (T); an
//    fp32 K tile lands swizzled and, rounded in place, is the hi operand
//    of q.k^T, a bf16 K tile and every V tile land row-major (row stride D);
//  - work (one tile): fp32: K's lo, V^T's hi and lo; bf16: K's hi (fp32)
//    and V^T's hi; V^T is D rows by KR keys, each group of 8 keys stored in
//    the order (0, 2, 4, 6, 1, 3, 5, 7), so that the score accumulator's
//    columns 2t, 2t + 1 feed k slots t, t + 4 of p.V's A fragment;
//  - at D 128 q's hi and lo tiles (64 x D); up to D 64 q's fragments stay
//    in registers instead.
// Tiles: 64 keys up to D 64, 32 at D 128; three stages at D 32, two above;
// fp32 takes 73 / 113 / 177 KB with the alignment pad (2, 2 and 1 CTAs an
// SM), bf16 less.
template <int D, typename T>
struct FwdTc {
  static constexpr bool F32 = std::is_same<T, float>::value;
  static constexpr int QR = 64, THREADS = 128;
  static constexpr int KR = D <= 64 ? 64 : 32;
  static constexpr int NS = D <= 32 ? 3 : 2;
  static constexpr bool QREG = D <= 64;
  static constexpr int CH = 16 / sizeof(T);            // elements a 16-byte copy
  static constexpr size_t RING = sizeof(T) * NS * 2 * KR * D;
  static constexpr size_t WORK = sizeof(float) * KR * D * (F32 ? 3 : 2);
  static constexpr size_t QS = QREG ? 0 : sizeof(float) * QR * D * (F32 ? 2 : 1);
  static constexpr size_t PAD = Sm90Swizzle128::ALIGN;   // to align the base
  static constexpr size_t SMEM = RING + WORK + QS + PAD;
  // CTAs an SM: as many as shared memory holds (228 KB an SM, 1 KB of it
  // reserved a CTA), at most 2 (registers: q's fragments, the score
  // chains, p's lo, o and each tile's two parts of o; at D 32 a bound of
  // 3 CTAs capped them at 168 and spilled 156-236 bytes, at 2 it takes
  // 220-242 and spills none)
  static constexpr int CTAS_PER_SM = 233472 / (SMEM + 1024) < 2
                                         ? static_cast<int>(233472 / (SMEM + 1024)) : 2;
  static_assert(KR * (D / CH) % THREADS == 0 && KR * D % (4 * THREADS) == 0 &&
                    D * KR % (8 * THREADS) == 0,
                "every thread takes the same number of copies and splits");
};

// x = hi + lo, lo exact in fp32 (and truncated to TF32 by the tensor
// core): hi = rna(x), to nearest with ties away (the integer form of
// cvt.rna.tf32), so |lo| <= 2^-11 |x| and lo's sign is x's or not, and
// the truncation of lo shrinks no product in one direction (with hi =
// trunc(x) every lo has x's sign and every score shrank by ~2^-21).
__device__ __forceinline__ float tf32_rna(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}
__device__ __forceinline__ float4 tf32_rna(float4 x) {
  return make_float4(tf32_rna(x.x), tf32_rna(x.y), tf32_rna(x.z), tf32_rna(x.w));
}
__device__ __forceinline__ float4 sub4(float4 a, float4 b) {
  return make_float4(a.x - b.x, a.y - b.y, a.z - b.z, a.w - b.w);
}
// 2^x by ex2.approx (relative error below 2^-22; 0 below about -126, so
// for the -1e30 mask value).  The forward keeps its scores and running max
// in log2 units (scaled by scale * log2(e)), so that p = 2^(s - m) is one
// FADD and one ex2, and turns m back into natural units for lse only.
constexpr float LOG2E = 1.4426950408889634f, LN2 = 0.6931471805599453f;
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// Issue the cp.async copies of key tile [k0, k0 + KR) of K and V into ring
// stage kv (K then V); rows at or past Sk are zero-filled.
template <int D, typename T>
__device__ __forceinline__ void fwd_stage(T* __restrict__ kv, const T* __restrict__ k,
                                          const T* __restrict__ v,
                                          long long base, long long krow,
                                          int rows) {
  using FT = FwdTc<D, T>;
  constexpr int KR = FT::KR, CH = FT::CH, PER_ROW = D / CH;
  T* vs = kv + KR * D;
#pragma unroll
  for (int u = 0; u < KR * PER_ROW / FT::THREADS; ++u) {
    const int i = threadIdx.x + u * FT::THREADS;
    const int r = i / PER_ROW, c = (i % PER_ROW) * CH;
    const bool ok = r < rows;
    const long long src = ok ? base + r * krow + c : 0;
    float* kd = reinterpret_cast<float*>(
        FT::F32 ? kv + Sm90Swizzle128::off(r, c, KR, D) : kv + r * D + c);
    dlk_cp_async16(kd, reinterpret_cast<const float*>(k + src), ok);
    dlk_cp_async16(reinterpret_cast<float*>(vs + r * D + c),
                   reinterpret_cast<const float*>(v + src), ok);
  }
}

// From ring stage kv: fp32 K's hi rounded in place and its lo into the
// work tiles, or bf16 K converted into them; V^T's hi (and lo, fp32) with
// each group of 8 keys in the order (0, 2, 4, 6, 1, 3, 5, 7).  Every load
// is issued before the first store (their latencies overlap); lanes take
// consecutive head-dim columns, so the V reads and the swizzled writes
// hit every bank once.
template <int D, typename T>
__device__ __forceinline__ void fwd_split(T* __restrict__ kv,
                                          float* __restrict__ work) {
  using FT = FwdTc<D, T>;
  constexpr int KR = FT::KR, NK = KR * D / 4 / FT::THREADS;
  constexpr int NV = D * (KR / 8) / FT::THREADS;
  const T* vs = kv + KR * D;
  float* k_op = work;                   // fp32: K's lo; bf16: K's hi
  float* vt_hi = work + KR * D;
  float* vt_lo = vt_hi + KR * D;        // fp32 only
  float4 x[NK];
  if constexpr (FT::F32) {
    // the same offsets as the landed tile, which takes K's hi in place
    float* kf = reinterpret_cast<float*>(kv);
#pragma unroll
    for (int u = 0; u < NK; ++u) x[u] = ld4(kf + 4 * (threadIdx.x + u * FT::THREADS));
#pragma unroll
    for (int u = 0; u < NK; ++u) {
      const float4 xh = tf32_rna(x[u]);
      st4(kf + 4 * (threadIdx.x + u * FT::THREADS), xh);
      st4(k_op + 4 * (threadIdx.x + u * FT::THREADS), sub4(x[u], xh));
    }
  } else {
#pragma unroll
    for (int u = 0; u < NK; ++u) {
      const int i = threadIdx.x + u * FT::THREADS;
      x[u] = ld4(kv + (i / (D / 4)) * D + (i % (D / 4)) * 4);
    }
#pragma unroll
    for (int u = 0; u < NK; ++u) {
      const int i = threadIdx.x + u * FT::THREADS;
      st4(k_op + Sm90Swizzle128::off(i / (D / 4), (i % (D / 4)) * 4, KR, D), x[u]);
    }
  }
  float y[NV][8];
#pragma unroll
  for (int u = 0; u < NV; ++u) {
    const int i = threadIdx.x + u * FT::THREADS, d = i % D, j = i / D;
#pragma unroll
    for (int e = 0; e < 8; ++e) y[u][e] = to_f32(vs[(8 * j + e) * D + d]);
  }
#pragma unroll
  for (int u = 0; u < NV; ++u) {
    const int i = threadIdx.x + u * FT::THREADS, d = i % D, j = i / D;
    const float4 even = make_float4(y[u][0], y[u][2], y[u][4], y[u][6]);
    const float4 odd = make_float4(y[u][1], y[u][3], y[u][5], y[u][7]);
    if constexpr (FT::F32) {
      const float4 eh = tf32_rna(even), oh = tf32_rna(odd);
      st4(vt_hi + Sm90Swizzle128::off(d, 8 * j, D, KR), eh);
      st4(vt_hi + Sm90Swizzle128::off(d, 8 * j + 4, D, KR), oh);
      st4(vt_lo + Sm90Swizzle128::off(d, 8 * j, D, KR), sub4(even, eh));
      st4(vt_lo + Sm90Swizzle128::off(d, 8 * j + 4, D, KR), sub4(odd, oh));
    } else {
      st4(vt_hi + Sm90Swizzle128::off(d, 8 * j, D, KR), even);
      st4(vt_hi + Sm90Swizzle128::off(d, 8 * j + 4, D, KR), odd);
    }
  }
}

template <int D, typename T, bool LSE>
__global__ void __launch_bounds__(128, FwdTc<D, T>::CTAS_PER_SM)
flash_fwd_tc(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o,
             float* __restrict__ lse, Shape sh) {
  using FT = FwdTc<D, T>;
  using SW = Sm90Swizzle128;
  constexpr int QR = FT::QR, KR = FT::KR, NS = FT::NS;
  constexpr int NJ = KR / 8, NO = D / 8;          // 8-column groups of s, of o
  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  {
    const uint32_t mis = static_cast<uint32_t>(__cvta_generic_to_shared(base)) & (FT::PAD - 1);
    base += mis ? FT::PAD - mis : 0;
  }
  T* ring = reinterpret_cast<T*>(base);
  float* work = reinterpret_cast<float*>(base + FT::RING);
  float* q_hi = work + (FT::F32 ? 3 : 2) * KR * D;   // D 128 only
  float* q_lo = q_hi + QR * D;                        // D 128, fp32 only
  const int nq = (sh.Sq + QR - 1) / QR;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * QR;  // long rows first
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / sh.G;
  const int warp = threadIdx.x / 32, g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const long long qrow = static_cast<long long>(sh.H) * D;
  const long long krow = static_cast<long long>(sh.KV) * D;
  const long long qoff = (static_cast<long long>(b) * sh.Sq + q0) * qrow + h * D;
  const long long kbase = static_cast<long long>(b) * sh.Sk * krow + kvh * D;
  int lo, hi;
  key_range<QR, KR>(sh, q0, lo, hi);
  const int ntiles = (hi - lo + KR - 1) / KR;

  // q: up to D 64 its A fragments in registers (hi and lo), at D 128 its
  // hi and lo tiles in shared memory (the copies in their own group)
  uint32_t qh[FT::QREG ? NO : 1][4], ql[FT::QREG ? NO : 1][4];
  if constexpr (FT::QREG) {
#pragma unroll
    for (int s = 0; s < NO; ++s)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 16 * warp + g + 8 * (i & 1), c = 8 * s + t + 4 * (i >> 1);
        const float x = q0 + r < sh.Sq ? to_f32(q[qoff + r * qrow + c]) : 0.0f;
        qh[s][i] = __float_as_uint(tf32_rna(x));
        ql[s][i] = __float_as_uint(x - tf32_rna(x));
      }
  } else {
    constexpr int PER_ROW = D / 4;
#pragma unroll 4
    for (int i = threadIdx.x; i < QR * PER_ROW; i += FT::THREADS) {
      const int r = i / PER_ROW, c = (i % PER_ROW) * 4;
      const bool ok = q0 + r < sh.Sq;
      if constexpr (FT::F32) {
        dlk_cp_async16(q_hi + SW::off(r, c, QR, D),
                       reinterpret_cast<const float*>(q + (ok ? qoff + r * qrow + c : 0)),
                       ok);
      } else {
        st4(q_hi + SW::off(r, c, QR, D),
            ok ? ld4(q + qoff + r * qrow + c) : make_float4(0.0f, 0.0f, 0.0f, 0.0f));
      }
    }
  }
  dlk_cp_async_commit();
  // the ring's first NS - 1 tiles, one group each
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) {
    if (i < ntiles) {
      const int k0 = lo + i * KR;
      fwd_stage<D, T>(ring + i * 2 * KR * D, k, v, kbase + k0 * krow, krow,
                      sh.Sk - k0);
    }
    dlk_cp_async_commit();
  }
  if constexpr (!FT::QREG && FT::F32) {
    dlk_cp_async_wait<NS - 1>();          // q's group is in
    __syncthreads();
#pragma unroll 4
    for (int i = threadIdx.x; i < QR * D / 4; i += FT::THREADS) {
      const float4 x = ld4(q_hi + 4 * i), xh = tf32_rna(x);
      st4(q_hi + 4 * i, xh);
      st4(q_lo + 4 * i, sub4(x, xh));
    }
  }

  const float scale_log2 = sh.scale * LOG2E;
  float acc[D / 2], m[2], l[2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
  m[0] = m[1] = NEG_INF;
  l[0] = l[1] = 0.0f;
  for (int it = 0; it < ntiles; ++it) {
    const int k0 = lo + it * KR;
    T* kv = ring + (it % NS) * 2 * KR * D;
    dlk_cp_async_wait<NS - 2>();          // tile it is in (this thread's copies)
    __syncthreads();   // ... every thread's; tile it - 1's stage and work are free
    if (it + NS - 1 < ntiles) {
      const int kn = k0 + (NS - 1) * KR;
      fwd_stage<D, T>(ring + ((it + NS - 1) % NS) * 2 * KR * D, k, v,
                      kbase + kn * krow, krow, sh.Sk - kn);
    }
    dlk_cp_async_commit();
    fwd_split<D, T>(kv, work);
    sm90_fence_proxy_async();
    __syncthreads();

    // s = q.k^T in 3xTF32 (bf16: q and k are exact in TF32, hi.hi alone).
    // The tensor core truncates its running sum at every step, so the
    // small terms (lo.hi, hi.lo) of every k-step go first, while the sum is
    // small, and the hi.hi terms are spread over SC chains (k-step d8 on
    // chain d8 % SC), added in fp32 at the end.  With every term on one
    // chain the error showed: greedy int8 streams of chip_smoke's serve
    // phases parted from ref's
    constexpr int SC = NO < 4 ? NO : 4;
    float sc[SC][KR / 2];
#pragma unroll
    for (int c = 0; c < SC; ++c)
#pragma unroll
      for (int i = 0; i < KR / 2; ++i) sc[c][i] = 0.0f;
    const float* k_hi = FT::F32 ? reinterpret_cast<const float*>(kv) : work;
#pragma unroll
    for (int c = 0; c < SC; ++c) sm90_fence_operand(sc[c]);
    sm90_wgmma_fence();
    if constexpr (FT::F32) {
#pragma unroll
      for (int d8 = 0; d8 < NO; ++d8) {
        if constexpr (FT::QREG) Sm90Tf32<KR>::rs(sc[0], ql[d8], SW::desc(k_hi, KR, D, d8));
        else Sm90Tf32<KR>::ss(sc[0], SW::desc(q_lo, QR, D, d8), SW::desc(k_hi, KR, D, d8));
      }
#pragma unroll
      for (int d8 = 0; d8 < NO; ++d8) {
        if constexpr (FT::QREG) Sm90Tf32<KR>::rs(sc[0], qh[d8], SW::desc(work, KR, D, d8));
        else Sm90Tf32<KR>::ss(sc[0], SW::desc(q_hi, QR, D, d8), SW::desc(work, KR, D, d8));
      }
    }
#pragma unroll
    for (int d8 = 0; d8 < NO; ++d8) {
      if constexpr (FT::QREG) Sm90Tf32<KR>::rs(sc[d8 % SC], qh[d8], SW::desc(k_hi, KR, D, d8));
      else Sm90Tf32<KR>::ss(sc[d8 % SC], SW::desc(q_hi, QR, D, d8), SW::desc(k_hi, KR, D, d8));
    }
    sm90_wgmma_commit();
    sm90_wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < SC; ++c) sm90_fence_operand(sc[c]);
    float (&s)[KR / 2] = sc[0];              // the scores: the chains' sum
#pragma unroll
    for (int c = 1; c < SC; ++c)
#pragma unroll
      for (int i = 0; i < KR / 2; ++i) s[i] += sc[c][i];

    // the online softmax on the thread's rows g (e < 2) and g + 8 (e >= 2),
    // each row's max and sum over the 4 lanes of its quad, in log2 units
    const bool full = tile_visible<QR, KR>(sh, q0, k0);
    float corr[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int qp = q0 + 16 * warp + g + 8 * hr;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kp = k0 + 8 * j + 2 * t + e;
          float& x = s[4 * j + 2 * hr + e];
          x = full || (kp < sh.Sk && visible(sh, qp, kp)) ? x * scale_log2 : NEG_INF;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
      const float m_new = fmaxf(m[hr], mx);
      corr[hr] = ex2(m[hr] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kp = k0 + 8 * j + 2 * t + e;
          float& x = s[4 * j + 2 * hr + e];
          x = full || kp < sh.Sk ? ex2(x - m_new) : 0.0f;
          sum += x;
        }
      sum += __shfl_xor_sync(FULL, sum, 1);
      sum += __shfl_xor_sync(FULL, sum, 2);
      l[hr] = l[hr] * corr[hr] + sum;
      m[hr] = m_new;
    }

    // the tile's p.v in 3xTF32 straight from the score registers (k slots
    // t and t + 4 of key group j are columns 8 j + 2 t and 8 j + 2 t + 1;
    // V^T's key order matches; p is fp32, its lo is never dropped), summed
    // apart and then added, o = o corr + part in fp32, for the same reason:
    // o accumulated on the tensor core over every tile took one truncation
    // at its full size for each of the tile's 3 KR / 8 products
    float plo[KR / 2], part[2][D / 2];
#pragma unroll
    for (int i = 0; i < KR / 2; ++i) {
      const float hv = tf32_rna(s[i]);
      plo[i] = s[i] - hv;
      s[i] = hv;
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) part[0][i] = part[1][i] = 0.0f;
    sm90_fence_operand(s);        // every A fragment and accumulator is
    sm90_fence_operand(plo);      // written before the first issue (else
    sm90_fence_operand(part[0]);  // ptxas serializes the products)
    sm90_fence_operand(part[1]);
    sm90_wgmma_fence();
    // the same order: every key group's small terms, then the hi.hi terms
    // on two chains (key group j on chain j % 2)
    auto frag = [](const float (&x)[KR / 2], int j, uint32_t (&a)[4]) {
      a[0] = __float_as_uint(x[4 * j]);
      a[1] = __float_as_uint(x[4 * j + 2]);
      a[2] = __float_as_uint(x[4 * j + 1]);
      a[3] = __float_as_uint(x[4 * j + 3]);
    };
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      uint32_t pl[4];
      frag(plo, j, pl);
      Sm90Tf32<D>::rs(part[0], pl, SW::desc(work + KR * D, D, KR, j));
    }
    if constexpr (FT::F32) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        uint32_t ph[4];
        frag(s, j, ph);
        Sm90Tf32<D>::rs(part[0], ph, SW::desc(work + 2 * KR * D, D, KR, j));
      }
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      uint32_t ph[4];
      frag(s, j, ph);
      Sm90Tf32<D>::rs(part[j % 2], ph, SW::desc(work + KR * D, D, KR, j));
    }
    sm90_wgmma_commit();
    sm90_wgmma_wait<0>();
    sm90_fence_operand(part[0]);
    sm90_fence_operand(part[1]);
#pragma unroll
    for (int i = 0; i < D / 2; ++i)
      acc[i] = fmaf(acc[i], corr[(i >> 1) & 1], part[0][i] + part[1][i]);
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = 16 * warp + g + 8 * hr;
    if (q0 + r >= sh.Sq) continue;
    const float lf = fmaxf(l[hr], 1e-30f);
#pragma unroll
    for (int j = 0; j < NO; ++j)
      st2(o + qoff + r * qrow + 8 * j + 2 * t, acc[4 * j + 2 * hr] / lf,
          acc[4 * j + 2 * hr + 1] / lf);
    if (LSE && t == 0)       // a row that saw no key keeps m = -1e30
      lse[(static_cast<long long>(b) * sh.H + h) * sh.Sq + q0 + r] =
          (m[hr] == NEG_INF ? NEG_INF : m[hr] * LN2) + logf(lf);
  }
}

// The forward at head dim 256 (flash_fwd_tc256, FwdTc256<T>): 3xTF32 on
// wgmma like flash_fwd_tc, with two consumer warpgroups (256 threads) a CTA
// of 64 query rows and key tiles of 32.  One warpgroup's 64 x 256 fp32
// accumulator alone would take 128 registers a thread, and K^T and V^T
// stored hi and lo at 256 columns beside a K/V ring would leave 16-key
// tiles in 227 KB, so:
//  1. the two warpgroups split each product: q.k^T by head-dim halves
//     (warpgroup w sums dims 128 w .. 128 w + 127 on its own chains), the
//     halves' scores meet through shared memory and are added in fp32 (in
//     the same order in both: a + b is b + a), and both run the same
//     online softmax; o by head-dim halves, warpgroup w owning o's dims
//     128 w .. 128 w + 127 (64 registers a thread);
//  2. o is accumulated transposed, o^T = V^T p^T: V is the A operand, read
//     by each thread straight from global memory (L2) into registers one
//     tile ahead and split into hi and lo there, and p^T the B operand, p
//     written to shared memory by the softmax (hi by warpgroup 0, lo by
//     warpgroup 1) in its natural key order.  So V is never staged,
//     transposed or split in shared memory, and q keeps its hi and lo
//     tiles (128 KB) for the score products;
//  3. K: one stage by cp.async (swizzled; fp32 rounded to its hi in place,
//     lo beside it; bf16 converted into an fp32 tile), the next tile's
//     copies issued as soon as both warpgroups' score products are done,
//     in flight during the softmax and p.V;
//  4. the grid is (query tiles, heads, batch): at RecurrentGemma's 1 x 300
//     prefill 80 CTAs, one wave at one CTA an SM.
// The G query heads of a KV head are not packed into a CTA's rows: at 64
// rows a CTA a tile of keys is visited as often either way, K and V (1 x
// 2100 x 256 fp32: 2.2 MB each) stay in L2, and the time is each CTA's
// chain of tensor-core products.  Product order: in each half, every
// k-step's small terms (q_lo k_hi, q_hi k_lo) on one chain, then the hi.hi
// terms spread over 4 chains (k-step s on chain s % 4), the chains added in
// fp32; each tile's p.V for each 64 dims summed apart (v_lo p_hi, v_hi
// p_lo, then v_hi p_hi) and added to o in fp32.
// Shared memory (fp32): q hi and lo 128 KB, the K stage 32 KB, K's lo 32
// KB, the halves' scores 16 KB, p's hi and lo 16 KB, corr and 1 / l
// 0.5 KB, the alignment pad 1 KB: 225.5 KB (bf16: 145.5 KB).
template <typename T>
struct FwdTc256 {
  static constexpr bool F32 = std::is_same<T, float>::value;
  static constexpr int D = 256, HALF = 128, QR = 64, KR = 32, THREADS = 256;
  static constexpr int CH = 16 / sizeof(T);            // elements a 16-byte copy
  static constexpr size_t QS = sizeof(float) * QR * D * (F32 ? 2 : 1);
  static constexpr size_t KSTAGE = sizeof(T) * KR * D;
  static constexpr size_t KWORK = sizeof(float) * KR * D;   // fp32: K's lo; bf16: K
  static constexpr size_t XS = sizeof(float) * 2 * QR * KR;
  static constexpr size_t PS = sizeof(float) * 2 * QR * KR;
  static constexpr size_t ROWS = sizeof(float) * 2 * QR;
  static constexpr size_t PAD = Sm90Swizzle128::ALIGN;
  static constexpr size_t SMEM = QS + KSTAGE + KWORK + XS + PS + ROWS + PAD;
  static_assert(QS % 1024 == 0 && KSTAGE % 1024 == 0 && KWORK % 1024 == 0 &&
                    XS % 1024 == 0 && (QR * KR * 4) % 1024 == 0,
                "every swizzled tile starts 1024-byte aligned");
  static_assert(KR * (D / CH) % THREADS == 0 && KR * D % (4 * THREADS) == 0,
                "every thread takes the same number of copies and splits");
};

// The cp.async copies of key tile [k0, k0 + 32) of K into the stage (fp32
// swizzled, bf16 row-major); rows at or past Sk are zero-filled.
template <typename T>
__device__ __forceinline__ void fwd256_stage(T* __restrict__ ks, const T* __restrict__ k,
                                             long long base, long long krow, int rows) {
  using FT = FwdTc256<T>;
  constexpr int KR = FT::KR, D = FT::D, CH = FT::CH, PER_ROW = D / CH;
#pragma unroll
  for (int u = 0; u < KR * PER_ROW / FT::THREADS; ++u) {
    const int i = threadIdx.x + u * FT::THREADS;
    const int r = i / PER_ROW, c = (i % PER_ROW) * CH;
    const bool ok = r < rows;
    const long long src = ok ? base + r * krow + c : 0;
    float* kd = reinterpret_cast<float*>(
        FT::F32 ? ks + Sm90Swizzle128::off(r, c, KR, D) : ks + r * D + c);
    dlk_cp_async16(kd, reinterpret_cast<const float*>(k + src), ok);
  }
}

// V's A fragments of one key tile for this thread (head-dim tiles dt of 64
// of its warpgroup's half, k-steps s of 8 keys; a[i] as sm90.cuh lays an
// m64k8 A out, rows = head dims), zero past Sk.
template <typename T>
__device__ __forceinline__ void fwd256_load_v(float (&vr)[2][4][4], const T* __restrict__ v,
                                              long long base, long long krow, int k0,
                                              int Sk, int dim0) {
#pragma unroll
  for (int dt = 0; dt < 2; ++dt)
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = k0 + 8 * s + (threadIdx.x % 4) + 4 * (i >> 1);
        const int d = dim0 + 64 * dt + 8 * (i & 1);
        vr[dt][s][i] = key < Sk ? to_f32(v[base + key * krow + d]) : 0.0f;
      }
}

template <typename T, bool LSE>
__global__ void __launch_bounds__(256, 1)
flash_fwd_tc256(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, T* __restrict__ o,
                float* __restrict__ lse, Shape sh) {
  using FT = FwdTc256<T>;
  using SW = Sm90Swizzle128;
  constexpr int D = FT::D, QR = FT::QR, KR = FT::KR, NJ = KR / 8;
  constexpr int NS = FT::HALF / 8, SC = 4;        // k-steps a half, score chains
  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  {
    const uint32_t mis = static_cast<uint32_t>(__cvta_generic_to_shared(base)) & (FT::PAD - 1);
    base += mis ? FT::PAD - mis : 0;
  }
  float* q_hi = reinterpret_cast<float*>(base);
  float* q_lo = q_hi + QR * D;                                  // fp32 only
  T* k_stage = reinterpret_cast<T*>(base + FT::QS);
  float* k_work = reinterpret_cast<float*>(base + FT::QS + FT::KSTAGE);
  float* xs = reinterpret_cast<float*>(base + FT::QS + FT::KSTAGE + FT::KWORK);
  float* p_hi = xs + 2 * QR * KR;
  float* p_lo = p_hi + QR * KR;
  float* corr_s = p_lo + QR * KR;
  float* lf_s = corr_s + QR;
  const int nq = (sh.Sq + QR - 1) / QR;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * QR;  // long rows first
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / sh.G;
  const int wg = threadIdx.x / 128, tw = threadIdx.x % 128;      // warpgroup, thread in it
  const int warp = tw / 32, g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const int dim0 = FT::HALF * wg + 16 * warp + g;               // o^T rows: +64 dt, +8
  const long long qrow = static_cast<long long>(sh.H) * D;
  const long long krow = static_cast<long long>(sh.KV) * D;
  const long long qoff = (static_cast<long long>(b) * sh.Sq + q0) * qrow + h * D;
  const long long kbase = static_cast<long long>(b) * sh.Sk * krow + kvh * D;
  int lo, hi;
  key_range<QR, KR>(sh, q0, lo, hi);
  const int ntiles = (hi - lo + KR - 1) / KR;

  // q (fp32 by cp.async, split into hi and lo below; bf16 converted, exact
  // in TF32), the first K tile, and the first V fragments
#pragma unroll 4
  for (int i = threadIdx.x; i < QR * D / 4; i += FT::THREADS) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    const bool ok = q0 + r < sh.Sq;
    if constexpr (FT::F32) {
      dlk_cp_async16(q_hi + SW::off(r, c, QR, D),
                     reinterpret_cast<const float*>(q + (ok ? qoff + r * qrow + c : 0)), ok);
    } else {
      st4(q_hi + SW::off(r, c, QR, D),
          ok ? ld4(q + qoff + r * qrow + c) : make_float4(0.0f, 0.0f, 0.0f, 0.0f));
    }
  }
  fwd256_stage<T>(k_stage, k, kbase + lo * krow, krow, sh.Sk - lo);
  dlk_cp_async_commit();
  float vr[2][4][4];
  fwd256_load_v<T>(vr, v, kbase, krow, lo, sh.Sk, dim0);
  if constexpr (FT::F32) {
    dlk_cp_async_wait<0>();
    __syncthreads();
#pragma unroll 4
    for (int i = threadIdx.x; i < QR * D / 4; i += FT::THREADS) {
      const float4 x = ld4(q_hi + 4 * i), xh = tf32_rna(x);
      st4(q_hi + 4 * i, xh);
      st4(q_lo + 4 * i, sub4(x, xh));
    }
  }

  const float scale_log2 = sh.scale * LOG2E;
  float acc[2][32], m[2], l[2];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[0][i] = acc[1][i] = 0.0f;
  m[0] = m[1] = NEG_INF;
  l[0] = l[1] = 0.0f;
  for (int it = 0; it < ntiles; ++it) {
    const int k0 = lo + it * KR;
    dlk_cp_async_wait<0>();             // K tile it is in (this thread's copies)
    __syncthreads();                    // ... every thread's
    // fp32: K's hi rounded in place, its lo beside it (same offsets); bf16:
    // K converted into the fp32 tile
    if constexpr (FT::F32) {
      float* kf = reinterpret_cast<float*>(k_stage);
#pragma unroll
      for (int u = 0; u < KR * D / 4 / FT::THREADS; ++u) {
        const int i = threadIdx.x + u * FT::THREADS;
        const float4 x = ld4(kf + 4 * i), xh = tf32_rna(x);
        st4(kf + 4 * i, xh);
        st4(k_work + 4 * i, sub4(x, xh));
      }
    } else {
#pragma unroll
      for (int u = 0; u < KR * D / 4 / FT::THREADS; ++u) {
        const int i = threadIdx.x + u * FT::THREADS;
        const int r = i / (D / 4), c = (i % (D / 4)) * 4;
        st4(k_work + SW::off(r, c, KR, D), ld4(k_stage + r * D + c));
      }
    }
    sm90_fence_proxy_async();
    __syncthreads();

    // this warpgroup's half of s = q.k^T: the small terms of its 16
    // k-steps first, then the hi.hi terms on SC chains
    const float* k_hi = FT::F32 ? reinterpret_cast<const float*>(k_stage) : k_work;
    const int s0 = NS * wg;
    float sc[SC][KR / 2];
#pragma unroll
    for (int c = 0; c < SC; ++c)
#pragma unroll
      for (int i = 0; i < KR / 2; ++i) sc[c][i] = 0.0f;
#pragma unroll
    for (int c = 0; c < SC; ++c) sm90_fence_operand(sc[c]);
    sm90_wgmma_fence();
    if constexpr (FT::F32) {
#pragma unroll
      for (int s = 0; s < NS; ++s)
        Sm90Tf32<KR>::ss(sc[0], SW::desc(q_lo, QR, D, s0 + s), SW::desc(k_hi, KR, D, s0 + s));
#pragma unroll
      for (int s = 0; s < NS; ++s)
        Sm90Tf32<KR>::ss(sc[0], SW::desc(q_hi, QR, D, s0 + s), SW::desc(k_work, KR, D, s0 + s));
    }
#pragma unroll
    for (int s = 0; s < NS; ++s)
      Sm90Tf32<KR>::ss(sc[s % SC], SW::desc(q_hi, QR, D, s0 + s), SW::desc(k_hi, KR, D, s0 + s));
    sm90_wgmma_commit();
    sm90_wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < SC; ++c) sm90_fence_operand(sc[c]);
    float (&s)[KR / 2] = sc[0];
#pragma unroll
    for (int c = 1; c < SC; ++c)
#pragma unroll
      for (int i = 0; i < KR / 2; ++i) s[i] += sc[c][i];

    // the halves meet: each warpgroup's scores out, then the other's in
    float* mine = xs + wg * QR * KR;
    const float* other = xs + (1 - wg) * QR * KR;
#pragma unroll
    for (int i = 0; i < KR / 2; ++i) mine[i * 128 + tw] = s[i];
    __syncthreads();                    // both halves written; K is free
    if (it + 1 < ntiles) {
      const int kn = k0 + KR;
      fwd256_stage<T>(k_stage, k, kbase + kn * krow, krow, sh.Sk - kn);
    }
    dlk_cp_async_commit();
#pragma unroll
    for (int i = 0; i < KR / 2; ++i) s[i] += other[i * 128 + tw];

    // the online softmax on the thread's rows g (e < 2) and g + 8 (e >= 2)
    // of its warp's 16, in log2 units, the same in both warpgroups
    const bool full = tile_visible<QR, KR>(sh, q0, k0);
    float corr[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int qp = q0 + 16 * warp + g + 8 * hr;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kp = k0 + 8 * j + 2 * t + e;
          float& x = s[4 * j + 2 * hr + e];
          x = full || (kp < sh.Sk && visible(sh, qp, kp)) ? x * scale_log2 : NEG_INF;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
      const float m_new = fmaxf(m[hr], mx);
      corr[hr] = ex2(m[hr] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kp = k0 + 8 * j + 2 * t + e;
          float& x = s[4 * j + 2 * hr + e];
          x = full || kp < sh.Sk ? ex2(x - m_new) : 0.0f;
          sum += x;
        }
      sum += __shfl_xor_sync(FULL, sum, 1);
      sum += __shfl_xor_sync(FULL, sum, 2);
      l[hr] = l[hr] * corr[hr] + sum;
      m[hr] = m_new;
    }
    // p (64 rows x 32 keys, swizzled: p^T's K-major B tile) as hi = rna(p)
    // by warpgroup 0 and lo = p - hi by warpgroup 1; corr by warpgroup 0
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = 16 * warp + g + 8 * hr;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float x0 = s[4 * j + 2 * hr], x1 = s[4 * j + 2 * hr + 1];
        const float h0 = tf32_rna(x0), h1 = tf32_rna(x1);
        st2(wg ? p_lo + SW::off(r, 8 * j + 2 * t, QR, KR)
               : p_hi + SW::off(r, 8 * j + 2 * t, QR, KR),
            wg ? x0 - h0 : h0, wg ? x1 - h1 : h1);
      }
      if (wg == 0 && t == 0) corr_s[r] = corr[hr];
    }
    sm90_fence_proxy_async();
    __syncthreads();

    // o^T += V^T p^T on this warpgroup's two 64-dim tiles, each tile's sum
    // apart: v_lo p_hi, v_hi p_lo, then v_hi p_hi (bf16: v exact, no v_lo)
    uint32_t vh[2][4][4], vl[2][4][4];
#pragma unroll
    for (int dt = 0; dt < 2; ++dt)
#pragma unroll
      for (int s8 = 0; s8 < 4; ++s8)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float x = vr[dt][s8][i], xh = FT::F32 ? tf32_rna(x) : x;
          vh[dt][s8][i] = __float_as_uint(xh);
          vl[dt][s8][i] = __float_as_uint(x - xh);
        }
    float part[2][32];
#pragma unroll
    for (int i = 0; i < 32; ++i) part[0][i] = part[1][i] = 0.0f;
    sm90_fence_operand(part[0]);
    sm90_fence_operand(part[1]);
#pragma unroll
    for (int dt = 0; dt < 2; ++dt)
#pragma unroll
      for (int s8 = 0; s8 < 4; ++s8) {
        asm volatile("" : "+r"(vh[dt][s8][0]), "+r"(vh[dt][s8][1]), "+r"(vh[dt][s8][2]),
                     "+r"(vh[dt][s8][3])::"memory");
        asm volatile("" : "+r"(vl[dt][s8][0]), "+r"(vl[dt][s8][1]), "+r"(vl[dt][s8][2]),
                     "+r"(vl[dt][s8][3])::"memory");
      }
    sm90_wgmma_fence();
#pragma unroll
    for (int dt = 0; dt < 2; ++dt) {
      if constexpr (FT::F32) {
#pragma unroll
        for (int s8 = 0; s8 < 4; ++s8)
          Sm90Tf32<64>::rs(part[dt], vl[dt][s8], SW::desc(p_hi, QR, KR, s8));
      }
#pragma unroll
      for (int s8 = 0; s8 < 4; ++s8)
        Sm90Tf32<64>::rs(part[dt], vh[dt][s8], SW::desc(p_lo, QR, KR, s8));
#pragma unroll
      for (int s8 = 0; s8 < 4; ++s8)
        Sm90Tf32<64>::rs(part[dt], vh[dt][s8], SW::desc(p_hi, QR, KR, s8));
    }
    sm90_wgmma_commit();
    sm90_wgmma_wait<0>();
    sm90_fence_operand(part[0]);
    sm90_fence_operand(part[1]);
    // the next tile's V fragments, in flight during its K wait and scores
    if (it + 1 < ntiles) fwd256_load_v<T>(vr, v, kbase, krow, k0 + KR, sh.Sk, dim0);
    // o^T's columns are query rows: column 8 j + 2 t + (e & 1) of register
    // 4 j + e
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 cj = *reinterpret_cast<const float2*>(corr_s + 8 * j + 2 * t);
#pragma unroll
      for (int dt = 0; dt < 2; ++dt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[dt][4 * j + e] = fmaf(acc[dt][4 * j + e], e & 1 ? cj.y : cj.x,
                                    part[dt][4 * j + e]);
    }
  }

  // each row's l (and lse) from warpgroup 0's copy of the row statistics
  if (wg == 0 && t == 0) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = 16 * warp + g + 8 * hr;
      const float lf = fmaxf(l[hr], 1e-30f);
      lf_s[r] = lf;
      if (LSE && q0 + r < sh.Sq)   // a row that saw no key keeps m = -1e30
        lse[(static_cast<long long>(b) * sh.H + h) * sh.Sq + q0 + r] =
            (m[hr] == NEG_INF ? NEG_INF : m[hr] * LN2) + logf(lf);
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = 8 * j + 2 * t + (e & 1);
      if (q0 + r >= sh.Sq) continue;
      const float lf = lf_s[r];
#pragma unroll
      for (int dt = 0; dt < 2; ++dt)
        st1(o + qoff + r * qrow + dim0 + 64 * dt + 8 * (e >> 1), acc[dt][4 * j + e] / lf);
    }
}

template <int D>
constexpr size_t dq_smem() {
  constexpr int Q = Tiles<D>::Q, K = Tiles<D>::K;
  return sizeof(float) * ((2 * Q + 2 * K) * (D + 4) + Q * (K + 4));
}
template <int D>
constexpr size_t dkv_smem() {
  constexpr int Q = Tiles<D>::Q, K = Tiles<D>::K;
  return sizeof(float) * ((2 * Q + 2 * K) * (D + 4) + 2 * K * (Q + 4) + 2 * Q);
}
template <int D>
constexpr size_t dq_tc_smem() {
  using TL = TcTiles<D>;
  return sizeof(float) * (2 * TL::DQ_Q * TL::STR +
                          2 * TL::STAGES * TL::DQ_K * TL::STR +
                          TL::DQ_Q * (TL::DQ_K + 4));
}
template <int D>
constexpr size_t dkv_tc_smem() {
  using TL = TcTiles<D>;
  return sizeof(float) * (2 * TL::DKV_K * TL::STR +
                          2 * TL::STAGES * TL::DKV_Q * TL::STR +
                          2 * TL::DKV_K * (TL::DKV_Q + 4) +
                          2 * TL::STAGES * TL::DKV_Q);
}
static_assert(dkv_smem<256>() <= 232448 && dq_smem<256>() <= 232448 &&
              dq_tc_smem<128>() <= 232448 && dkv_tc_smem<128>() <= 232448 &&
              FwdTc<128, float>::SMEM <= 232448 &&
              FwdTc256<float>::SMEM <= 232448 && FwdTc256<__nv_bfloat16>::SMEM <= 232448 &&
              FwdTc<64, float>::CTAS_PER_SM == 2,
              "a tile set must fit 227 KB (the forward's at head dim 64 twice an SM)");

Shape make_shape(int Sq, int Sk, int H, int KV, int D, int causal, int window) {
  Shape sh;
  sh.Sq = Sq;
  sh.Sk = Sk;
  sh.H = H;
  sh.KV = KV;
  sh.G = H / KV;
  sh.causal = causal;
  sh.window = window;
  sh.scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  return sh;
}

// The forward: flash_fwd_tc up to head dim 128, flash_fwd_tc256 at 256
// (RecurrentGemma's local attention): both
// 3xTF32 on wgmma, 64 query rows a CTA.
template <int D, typename T, bool LSE>
int launch_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
               int B, const Shape& sh, cudaStream_t stream) {
  static DlkSmemOnce once;
  auto run = [&](auto kern, size_t smem, int rows, int threads) {
    if (int err = dlk_prepare_smem(kern, smem, once, true)) return err;
    const dim3 grid((sh.Sq + rows - 1) / rows, sh.H, B);
    kern<<<grid, threads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), lse, sh);
    return dlk_last_error();
  };
  if constexpr (D <= 128) {
    using FT = FwdTc<D, T>;
    return run(flash_fwd_tc<D, T, LSE>, FT::SMEM, FT::QR, FT::THREADS);
  } else {
    using FT = FwdTc256<T>;
    return run(flash_fwd_tc256<T, LSE>, FT::SMEM, FT::QR, FT::THREADS);
  }
}

// dq and dk/dv: the tensor-core kernels up to head dim 128, the FFMA
// kernels at 256 (their fragments would not fit the registers).
template <int D, typename T>
auto dq_kernel() {
  if constexpr (D <= 128) return flash_dq_tc<D, T>;
  else return flash_dq<D, T>;
}
template <int D, typename T>
auto dkv_kernel() {
  if constexpr (D <= 128) return flash_dkv_tc<D, T>;
  else return flash_dkv<D, T>;
}

template <int D, typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* dsum, void* dq, int B,
              const Shape& sh, cudaStream_t stream) {
  constexpr bool TC = D <= 128;
  auto kern = dq_kernel<D, T>();
  constexpr size_t smem = TC ? dq_tc_smem<D>() : dq_smem<D>();
  constexpr int QR = TC ? TcTiles<D>::DQ_Q : Tiles<D>::Q;
  constexpr int NTHR = TC ? TcTiles<D>::THREADS : THREADS;
  static DlkSmemOnce once;
  if (int err = dlk_prepare_smem(kern, smem, once)) return err;
  const dim3 grid((sh.Sq + QR - 1) / QR, sh.H, B);
  kern<<<grid, NTHR, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, dsum,
      static_cast<T*>(dq), sh);
  return dlk_last_error();
}

template <int D, typename T>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* dsum, void* dk, void* dv, int B,
               const Shape& sh, cudaStream_t stream) {
  constexpr bool TC = D <= 128;
  auto kern = dkv_kernel<D, T>();
  constexpr size_t smem = TC ? dkv_tc_smem<D>() : dkv_smem<D>();
  constexpr int KR = TC ? TcTiles<D>::DKV_K : Tiles<D>::K;
  constexpr int NTHR = TC ? TcTiles<D>::THREADS : THREADS;
  static DlkSmemOnce once;
  if (int err = dlk_prepare_smem(kern, smem, once)) return err;
  const dim3 grid((sh.Sk + KR - 1) / KR, sh.KV, B);
  kern<<<grid, NTHR, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, dsum,
      static_cast<T*>(dk), static_cast<T*>(dv), sh);
  return dlk_last_error();
}

// dtype codes (the same numbers as DTYPES in
// repro_torch/kernels/flash_attention.py)
enum DlkFlashDtype : int { DLK_F32 = 0, DLK_BF16 = 1 };

template <template <int, typename> class F, int D, typename... A>
int dispatch_dtype(int dtype, A... args) {
  if (dtype == DLK_F32) return F<D, float>::run(args...);
  if (dtype == DLK_BF16) return F<D, __nv_bfloat16>::run(args...);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Calls F<D, T>::run for a supported (head_dim, dtype);
// cudaErrorInvalidValue for any other.
template <template <int, typename> class F, typename... A>
int dispatch(int D, int dtype, A... args) {
  switch (D) {
    case 32: return dispatch_dtype<F, 32>(dtype, args...);
    case 64: return dispatch_dtype<F, 64>(dtype, args...);
    case 128: return dispatch_dtype<F, 128>(dtype, args...);
    case 256: return dispatch_dtype<F, 256>(dtype, args...);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int D, typename T>
struct Fwd {
  static int run(const void* q, const void* k, const void* v, void* o,
                 float* lse, int B, Shape sh, cudaStream_t s) {
    return lse ? launch_fwd<D, T, true>(q, k, v, o, lse, B, sh, s)
               : launch_fwd<D, T, false>(q, k, v, o, nullptr, B, sh, s);
  }
};

template <int D, typename T>
struct Dq {
  static int run(const void* q, const void* k, const void* v, const void* dout,
                 const float* lse, const float* dsum, void* dq, int B, Shape sh,
                 cudaStream_t s) {
    return launch_dq<D, T>(q, k, v, dout, lse, dsum, dq, B, sh, s);
  }
};

template <int D, typename T>
struct Dkv {
  static int run(const void* q, const void* k, const void* v, const void* dout,
                 const float* lse, const float* dsum, void* dk, void* dv, int B,
                 Shape sh, cudaStream_t s) {
    return launch_dkv<D, T>(q, k, v, dout, lse, dsum, dk, dv, B, sh, s);
  }
};

}  // namespace

// B8: o (B, Sq, H, D) = attention of q (B, Sq, H, D) over k, v
// (B, Sk, KV, D), contiguous, in fp32 or bf16 (dtype), head_dim 32, 64, 128
// or 256.
extern "C" int dlk_flash_attention(const void* q, const void* k, const void* v,
                                   void* o, int B, int Sq, int Sk, int H,
                                   int KV, int D, int dtype, int causal,
                                   int window, cudaStream_t stream) {
  const Shape sh = make_shape(Sq, Sk, H, KV, D, causal, window);
  return dispatch<Fwd>(D, dtype, q, k, v, o, static_cast<float*>(nullptr), B,
                       sh, stream);
}

// B9's forward: the same, and lse (B, H, Sq) fp32.
extern "C" int dlk_flash_attention_fwd(const void* q, const void* k,
                                       const void* v, void* o, float* lse,
                                       int B, int Sq, int Sk, int H, int KV,
                                       int D, int dtype, int causal,
                                       int window, cudaStream_t stream) {
  const Shape sh = make_shape(Sq, Sk, H, KV, D, causal, window);
  return dispatch<Fwd>(D, dtype, q, k, v, o, lse, B, sh, stream);
}

// B9's dq (B, Sq, H, D) from q, dO (B, Sq, H, D), k, v (B, Sk, KV, D), lse
// and dsum = rowsum(dO * o), both (B, H, Sq) fp32.
extern "C" int dlk_flash_attention_dq(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const float* lse, const float* dsum,
                                      void* dq, int B, int Sq, int Sk, int H,
                                      int KV, int D, int dtype, int causal,
                                      int window, cudaStream_t stream) {
  const Shape sh = make_shape(Sq, Sk, H, KV, D, causal, window);
  return dispatch<Dq>(D, dtype, q, k, v, dout, lse, dsum, dq, B, sh, stream);
}

// B9's dk, dv (B, Sk, KV, D), each summed over the KV head's G query heads.
extern "C" int dlk_flash_attention_dkv(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const float* lse, const float* dsum,
                                       void* dk, void* dv, int B, int Sq,
                                       int Sk, int H, int KV, int D, int dtype,
                                       int causal, int window,
                                       cudaStream_t stream) {
  const Shape sh = make_shape(Sq, Sk, H, KV, D, causal, window);
  return dispatch<Dkv>(D, dtype, q, k, v, dout, lse, dsum, dk, dv, B, sh,
                       stream);
}
