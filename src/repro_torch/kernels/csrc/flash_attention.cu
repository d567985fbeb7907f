// B8 + B9: full-sequence flash attention (prefill and training) with causal
// and sliding-window masks and GQA, in fp32 or bf16: the forward, with the
// per-row logsumexp when the backward needs it, and the FlashAttention-2
// backward (dq, and dk/dv summed over each KV head's group).
//
// Replaces repro/kernels/flash_attention.py::flash_attention (B8, body
// _flash_kernel) and repro/kernels/flash_attention_bwd.py (B9: _fwd_kernel,
// _dq_kernel, _dkv_kernel).  On the TPU the grid (B*H, S/bq, S/bk) walks
// the KV axis in order and carries (m, l, acc) in VMEM scratch from one
// grid step to the next; the inputs are transposed to (B*H, S, D) first,
// S must be a multiple of the block, and every KV block is visited (the
// mask zeroes the invisible ones).  dk/dv are computed per query head and
// summed over the group outside the kernel.
//
// Bound on the H100: operations.  A 64 x 64 score tile costs 2*64*64*D
// flops for QK^T and as many for PV against 2*64*D*4 bytes of K/V, so the
// kernels sit far above the fp32 ridge (~20 flops per byte) at S >= 64.
//
// Design (fp32 FFMA, no tensor cores and no TF32):
//  - one CTA of 256 threads per (query tile of 64 rows, head, batch) for the
//    forward and dq, per (key tile of 64 rows, KV head, batch) for dk/dv;
//  - the loop over the other axis is inside the CTA and bounded by the
//    causal and window limits, so a tile that no row can see is never
//    loaded; the ragged edge of S is masked (rows and keys past S are
//    zero-filled and masked), so S needs no padding;
//  - tiles are read by strides straight from (B, S, H, D) / (B, S, KV, D)
//    (no transposes), converted to fp32 in shared memory;
//  - thread (ty, tx) of a 16 x 16 grid owns rows ty + 16 i and score
//    columns tx + 16 j (i, j < 4) of a 64 x 64 tile, and D / 16 output
//    columns of its rows (4 tx + 64 j + e for head_dim 64 and 128, 2 tx + e
//    for 32), so the row statistics of the online softmax stay in its
//    registers and are reduced over 16 lanes by shuffles; products read
//    float4 rows of padded shared tiles;
//  - masked scores never enter the softmax: they count as -1e30 for the
//    running max and as exactly 0 for p, so a row whose first visited tile
//    is fully masked (a sliding window) carries l = 0 and acc = 0 instead
//    of the reference's garbage that a later corr = 0 wipes;
//  - lse = m + log(max(l, 1e-30)), as the reference writes it, so the
//    backward's exp(s - lse) are the forward's probabilities;
//  - dk/dv: one CTA per key tile loops over the G query heads of its KV
//    head and over the query tiles that can see it, accumulating dk and dv
//    in fp32 registers, and writes the group sum once (the reference's
//    per-head outputs and their sum over G are never stored).
//
// Not yet done (a later PR): wgmma/TMA tensor-core tiles, bf16 products.
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "common.cuh"

namespace {

constexpr int BQ = 64;             // query rows per tile
constexpr int BK = 64;             // key rows per tile
constexpr int THREADS = 256;       // a 16 x 16 grid
constexpr int PS = BK + 4;         // row stride of the 64 x 64 P / dS tiles
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

struct Shape {
  int S, H, KV, G;                 // sequence, query heads, KV heads, H / KV
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

// The D / 16 output columns that thread tx owns in a row of D: float4
// groups 4 tx + 64 j + e (e < 4) for D = 64 and 128, one float2 pair
// 2 tx + e (e < 2) for D = 32.
template <int D>
__device__ __forceinline__ void ld_cols(float (&x)[D / 16], const float* row,
                                        int tx) {
  if constexpr (D == 32) {
    const float2 a = *reinterpret_cast<const float2*>(row + 2 * tx);
    x[0] = a.x;
    x[1] = a.y;
  } else {
#pragma unroll
    for (int j = 0; j < D / 64; ++j) {
      const float4 a = ld4(row + 4 * tx + 64 * j);
      x[4 * j + 0] = a.x;
      x[4 * j + 1] = a.y;
      x[4 * j + 2] = a.z;
      x[4 * j + 3] = a.w;
    }
  }
}
template <int D, typename T>
__device__ __forceinline__ void st_cols(T* row, const float (&x)[D / 16],
                                        int tx) {
  if constexpr (D == 32) {
    st2(row + 2 * tx, x[0], x[1]);
  } else {
#pragma unroll
    for (int j = 0; j < D / 64; ++j)
      st4(row + 4 * tx + 64 * j,
          make_float4(x[4 * j], x[4 * j + 1], x[4 * j + 2], x[4 * j + 3]));
  }
}

__device__ __forceinline__ bool visible(const Shape& sh, int qp, int kp) {
  return qp < sh.S && kp < sh.S && (!sh.causal || kp <= qp) &&
         (!sh.window || kp > qp - sh.window);
}

// Tile-aligned first key and the key bound that the query rows
// [q0, q0 + BQ) can see: nothing outside [lo, hi) is visited.
__device__ __forceinline__ void key_range(const Shape& sh, int q0, int& lo,
                                          int& hi) {
  const int q_last = min(q0 + BQ, sh.S) - 1;
  hi = sh.causal ? q_last + 1 : sh.S;
  lo = sh.window ? max(0, q0 - sh.window + 1) : 0;
  lo = (lo / BK) * BK;
}

// 64 rows of D elements, row r at src + r * row_stride, into a shared tile
// of stride D + 4 as fp32; rows at or past `rows` are zero.
template <int D, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          long long row_stride, int rows) {
  constexpr int V = D / 4, STR = D + 4;
#pragma unroll 4
  for (int i = threadIdx.x; i < 64 * V; i += THREADS) {
    const int r = i / V, c = (i % V) * 4;
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (r < rows) x = ld4(src + r * row_stride + c);
    st4(dst + r * STR + c, x);
  }
}

// acc[i][j] = sum_d A[ty + 16 i][d] * B[tx + 16 j][d] over two 64-row
// shared tiles of stride D + 4.
template <int D>
__device__ __forceinline__ void dot_tile(float (&acc)[4][4], const float* A,
                                         const float* B, int ty, int tx) {
  constexpr int STR = D + 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = ld4(A + (ty + 16 * i) * STR + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = ld4(B + (tx + 16 * j) * STR + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
        acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
        acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
        acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
      }
  }
}

// acc[i][e] += sum_c P[ty + 16 i][c] * M[c][column e of tx]: a 64 x 64
// tile (stride PS) times a 64-row tile of stride D + 4.
template <int D>
__device__ __forceinline__ void pm_tile(float (&acc)[4][D / 16], const float* P,
                                        const float* M, int ty, int tx) {
  constexpr int STR = D + 4;
#pragma unroll 2
  for (int c = 0; c < 64; c += 4) {
    float4 p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = ld4(P + (ty + 16 * i) * PS + c);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      float m[D / 16];
      ld_cols<D>(m, M + (c + cc) * STR, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pc = cc == 0 ? p[i].x : cc == 1 ? p[i].y
                       : cc == 2 ? p[i].z : p[i].w;
#pragma unroll
        for (int e = 0; e < D / 16; ++e) acc[i][e] = fmaf(pc, m[e], acc[i][e]);
      }
    }
  }
}

__device__ __forceinline__ float max16(float x) {
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}
__device__ __forceinline__ float sum16(float x) {
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

// Rows [0, 64) of a tile: row r of the accumulator acc[i] is row ty + 16 i;
// writes acc / div (div = 1 when null) as T at dst + r * row_stride.
template <int D, typename T>
__device__ __forceinline__ void store_rows(T* dst, long long row_stride,
                                           int rows, const float (&acc)[4][D / 16],
                                           const float* div, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= rows) continue;
    float x[D / 16];
#pragma unroll
    for (int e = 0; e < D / 16; ++e) x[e] = div ? acc[i][e] / div[i] : acc[i][e];
    st_cols<D>(dst + r * row_stride, x, tx);
  }
}

// ---------------------------------------------------------------------------
// forward: o (B, S, H, D) and, with LSE, lse (B, H, S) fp32
// ---------------------------------------------------------------------------

template <int D, typename T, bool LSE>
__global__ void __launch_bounds__(THREADS)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
          Shape sh) {
  constexpr int STR = D + 4;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);   // BQ x STR
  float* k_s = q_s + BQ * STR;                    // BK x STR
  float* v_s = k_s + BK * STR;                    // BK x STR
  float* p_s = v_s + BK * STR;                    // BQ x PS
  const int nq = (sh.S + BQ - 1) / BQ;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * BQ;  // long rows first
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / sh.G;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const long long qrow = static_cast<long long>(sh.H) * D;
  const long long krow = static_cast<long long>(sh.KV) * D;
  const long long qoff = (static_cast<long long>(b) * sh.S + q0) * qrow + h * D;
  const long long kbase = static_cast<long long>(b) * sh.S * krow + kvh * D;
  load_tile<D>(q_s, q + qoff, qrow, sh.S - q0);

  float m[4], l[4], acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc[i][c] = 0.0f;
  }
  int lo, hi;
  key_range(sh, q0, lo, hi);
  for (int k0 = lo; k0 < hi; k0 += BK) {
    __syncthreads();                    // the previous tiles are consumed
    load_tile<D>(k_s, k + kbase + k0 * krow, krow, sh.S - k0);
    load_tile<D>(v_s, v + kbase + k0 * krow, krow, sh.S - k0);
    __syncthreads();
    float s[4][4];
    dot_tile<D>(s, q_s, k_s, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty + 16 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = visible(sh, qp, k0 + tx + 16 * j) ? s[i][j] * sh.scale
                                                    : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], max16(mx));
      const float corr = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = visible(sh, qp, k0 + tx + 16 * j)
                            ? expf(s[i][j] - m_new) : 0.0f;
        p_s[(ty + 16 * i) * PS + tx + 16 * j] = p;
        sum += p;
      }
      l[i] = l[i] * corr + sum16(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < D / 16; ++c) acc[i][c] *= corr;
    }
    __syncthreads();
    pm_tile<D>(acc, p_s, v_s, ty, tx);
  }
  float lf[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) lf[i] = fmaxf(l[i], 1e-30f);
  store_rows<D>(o + qoff, qrow, sh.S - q0, acc, lf, ty, tx);
  if (LSE && tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty + 16 * i;
      if (qp < sh.S)
        lse[(static_cast<long long>(b) * sh.H + h) * sh.S + qp] =
            m[i] + logf(lf[i]);
    }
  }
}

// ---------------------------------------------------------------------------
// dq (B, S, H, D): sum over visible keys of ds k, ds = p (dO v^T - dsum) scale
// ---------------------------------------------------------------------------

template <int D, typename T>
__global__ void __launch_bounds__(THREADS)
flash_dq(const T* __restrict__ q, const T* __restrict__ k,
         const T* __restrict__ v, const T* __restrict__ dout,
         const float* __restrict__ lse, const float* __restrict__ dsum,
         T* __restrict__ dq, Shape sh) {
  constexpr int STR = D + 4;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);   // BQ x STR
  float* do_s = q_s + BQ * STR;                   // BQ x STR
  float* k_s = do_s + BQ * STR;                   // BK x STR
  float* v_s = k_s + BK * STR;                    // BK x STR
  float* ds_s = v_s + BK * STR;                   // BQ x PS
  const int nq = (sh.S + BQ - 1) / BQ;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * BQ;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / sh.G;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const long long qrow = static_cast<long long>(sh.H) * D;
  const long long krow = static_cast<long long>(sh.KV) * D;
  const long long qoff = (static_cast<long long>(b) * sh.S + q0) * qrow + h * D;
  const long long kbase = static_cast<long long>(b) * sh.S * krow + kvh * D;
  const long long row0 = (static_cast<long long>(b) * sh.H + h) * sh.S + q0;
  load_tile<D>(q_s, q + qoff, qrow, sh.S - q0);
  load_tile<D>(do_s, dout + qoff, qrow, sh.S - q0);
  float lse_r[4], dsum_r[4], acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const bool in = q0 + ty + 16 * i < sh.S;
    lse_r[i] = in ? lse[row0 + ty + 16 * i] : 0.0f;
    dsum_r[i] = in ? dsum[row0 + ty + 16 * i] : 0.0f;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc[i][c] = 0.0f;
  }
  int lo, hi;
  key_range(sh, q0, lo, hi);
  for (int k0 = lo; k0 < hi; k0 += BK) {
    __syncthreads();
    load_tile<D>(k_s, k + kbase + k0 * krow, krow, sh.S - k0);
    load_tile<D>(v_s, v + kbase + k0 * krow, krow, sh.S - k0);
    __syncthreads();
    float s[4][4], dp[4][4];
    dot_tile<D>(s, q_s, k_s, ty, tx);
    dot_tile<D>(dp, do_s, v_s, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = visible(sh, qp, k0 + tx + 16 * j)
                            ? expf(s[i][j] * sh.scale - lse_r[i]) : 0.0f;
        ds_s[(ty + 16 * i) * PS + tx + 16 * j] =
            p * (dp[i][j] - dsum_r[i]) * sh.scale;
      }
    }
    __syncthreads();
    pm_tile<D>(acc, ds_s, k_s, ty, tx);
  }
  store_rows<D>(dq + qoff, qrow, sh.S - q0, acc, nullptr, ty, tx);
}

// ---------------------------------------------------------------------------
// dk, dv (B, S, KV, D): per key tile, summed over the G query heads of its
// KV head and the query rows that see it
// ---------------------------------------------------------------------------

template <int D, typename T>
__global__ void __launch_bounds__(THREADS)
flash_dkv(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ dsum,
          T* __restrict__ dk, T* __restrict__ dv, Shape sh) {
  constexpr int STR = D + 4;
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);   // BK x STR
  float* v_s = k_s + BK * STR;                    // BK x STR
  float* q_s = v_s + BK * STR;                    // BQ x STR
  float* do_s = q_s + BQ * STR;                   // BQ x STR
  float* pt_s = do_s + BQ * STR;                  // BK x PS: p^T
  float* dst_s = pt_s + BK * PS;                  // BK x PS: ds^T
  float* lse_s = dst_s + BK * PS;                 // BQ
  float* dsum_s = lse_s + BQ;                     // BQ
  const int k0 = blockIdx.x * BK, kvh = blockIdx.y, b = blockIdx.z;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const long long qrow = static_cast<long long>(sh.H) * D;
  const long long krow = static_cast<long long>(sh.KV) * D;
  const long long koff = (static_cast<long long>(b) * sh.S + k0) * krow + kvh * D;
  load_tile<D>(k_s, k + koff, krow, sh.S - k0);
  load_tile<D>(v_s, v + koff, krow, sh.S - k0);
  // the query rows that can see a key of [k0, k_last]
  const int k_last = min(k0 + BK, sh.S) - 1;
  const int q_lo = sh.causal ? (k0 / BQ) * BQ : 0;
  const int q_hi = sh.window ? min(sh.S, k_last + sh.window) : sh.S;

  float dk_acc[4][D / 16], dv_acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.0f;
  for (int g = 0; g < sh.G; ++g) {
    const int h = kvh * sh.G + g;
    for (int q0 = q_lo; q0 < q_hi; q0 += BQ) {
      __syncthreads();
      const long long qoff = (static_cast<long long>(b) * sh.S + q0) * qrow + h * D;
      load_tile<D>(q_s, q + qoff, qrow, sh.S - q0);
      load_tile<D>(do_s, dout + qoff, qrow, sh.S - q0);
      if (threadIdx.x < BQ) {
        const int r = threadIdx.x;
        const long long row = (static_cast<long long>(b) * sh.H + h) * sh.S + q0 + r;
        const bool in = q0 + r < sh.S;
        lse_s[r] = in ? lse[row] : 0.0f;
        dsum_s[r] = in ? dsum[row] : 0.0f;
      }
      __syncthreads();
      float s[4][4], dp[4][4];          // [key ty + 16 i][query tx + 16 j]
      dot_tile<D>(s, k_s, q_s, ty, tx);
      dot_tile<D>(dp, v_s, do_s, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kp = k0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = tx + 16 * j;
          const float p = visible(sh, q0 + r, kp)
                              ? expf(s[i][j] * sh.scale - lse_s[r]) : 0.0f;
          pt_s[(ty + 16 * i) * PS + r] = p;
          dst_s[(ty + 16 * i) * PS + r] = p * (dp[i][j] - dsum_s[r]) * sh.scale;
        }
      }
      __syncthreads();
      pm_tile<D>(dv_acc, pt_s, do_s, ty, tx);
      pm_tile<D>(dk_acc, dst_s, q_s, ty, tx);
    }
  }
  store_rows<D>(dk + koff, krow, sh.S - k0, dk_acc, nullptr, ty, tx);
  store_rows<D>(dv + koff, krow, sh.S - k0, dv_acc, nullptr, ty, tx);
}

constexpr size_t fwd_smem(int D) { return sizeof(float) * (3 * 64 * (D + 4) + 64 * PS); }
constexpr size_t dq_smem(int D) { return sizeof(float) * (4 * 64 * (D + 4) + 64 * PS); }
constexpr size_t dkv_smem(int D) {
  return sizeof(float) * (4 * 64 * (D + 4) + 2 * 64 * PS + 2 * 64);
}

constexpr int MAX_DEVICES = 64;

// Above 48 KB a block's shared memory must be asked for: once per kernel
// and device, at its first launch there (`done` is the kernel's own).
template <typename K>
int prepare(K kern, size_t smem, std::atomic<bool> (&done)[MAX_DEVICES]) {
  int dev = 0;
  if (cudaError_t err = cudaGetDevice(&dev)) return static_cast<int>(err);
  const bool known = dev < MAX_DEVICES;
  if (known && done[dev].load(std::memory_order_acquire)) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err == cudaSuccess && known) done[dev].store(true, std::memory_order_release);
  return static_cast<int>(err);
}

Shape make_shape(int S, int H, int KV, int D, int causal, int window) {
  Shape sh;
  sh.S = S;
  sh.H = H;
  sh.KV = KV;
  sh.G = H / KV;
  sh.causal = causal;
  sh.window = window;
  sh.scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  return sh;
}

template <int D, typename T, bool LSE>
int launch_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
               int B, const Shape& sh, cudaStream_t stream) {
  auto kern = flash_fwd<D, T, LSE>;
  static std::atomic<bool> done[MAX_DEVICES];
  if (int err = prepare(kern, fwd_smem(D), done)) return err;
  const dim3 grid((sh.S + BQ - 1) / BQ, sh.H, B);
  kern<<<grid, THREADS, fwd_smem(D), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, sh);
  return dlk_last_error();
}

template <int D, typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* dsum, void* dq, int B,
              const Shape& sh, cudaStream_t stream) {
  auto kern = flash_dq<D, T>;
  static std::atomic<bool> done[MAX_DEVICES];
  if (int err = prepare(kern, dq_smem(D), done)) return err;
  const dim3 grid((sh.S + BQ - 1) / BQ, sh.H, B);
  kern<<<grid, THREADS, dq_smem(D), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, dsum,
      static_cast<T*>(dq), sh);
  return dlk_last_error();
}

template <int D, typename T>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* dsum, void* dk, void* dv, int B,
               const Shape& sh, cudaStream_t stream) {
  auto kern = flash_dkv<D, T>;
  static std::atomic<bool> done[MAX_DEVICES];
  if (int err = prepare(kern, dkv_smem(D), done)) return err;
  const dim3 grid((sh.S + BK - 1) / BK, sh.KV, B);
  kern<<<grid, THREADS, dkv_smem(D), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, dsum,
      static_cast<T*>(dk), static_cast<T*>(dv), sh);
  return dlk_last_error();
}

// dtype codes (the same numbers as DTYPES in
// repro_torch/kernels/flash_attention.py)
enum DlkFlashDtype : int { DLK_F32 = 0, DLK_BF16 = 1 };

// Calls f<D, T>() for a supported (head_dim, dtype); cudaErrorInvalidValue
// for any other.
template <template <int, typename> class F, typename... A>
int dispatch(int D, int dtype, A... args) {
  if (D == 32 && dtype == DLK_F32) return F<32, float>::run(args...);
  if (D == 32 && dtype == DLK_BF16) return F<32, __nv_bfloat16>::run(args...);
  if (D == 64 && dtype == DLK_F32) return F<64, float>::run(args...);
  if (D == 64 && dtype == DLK_BF16) return F<64, __nv_bfloat16>::run(args...);
  if (D == 128 && dtype == DLK_F32) return F<128, float>::run(args...);
  if (D == 128 && dtype == DLK_BF16) return F<128, __nv_bfloat16>::run(args...);
  return static_cast<int>(cudaErrorInvalidValue);
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

// B8: o (B, S, H, D) = attention of q (B, S, H, D) over k, v (B, S, KV, D),
// contiguous, in fp32 or bf16 (dtype), head_dim 32, 64 or 128.
extern "C" int dlk_flash_attention(const void* q, const void* k, const void* v,
                                   void* o, int B, int S, int H, int KV, int D,
                                   int dtype, int causal, int window,
                                   cudaStream_t stream) {
  const Shape sh = make_shape(S, H, KV, D, causal, window);
  return dispatch<Fwd>(D, dtype, q, k, v, o, static_cast<float*>(nullptr), B,
                       sh, stream);
}

// B9's forward: the same, and lse (B, H, S) fp32.
extern "C" int dlk_flash_attention_fwd(const void* q, const void* k,
                                       const void* v, void* o, float* lse,
                                       int B, int S, int H, int KV, int D,
                                       int dtype, int causal, int window,
                                       cudaStream_t stream) {
  const Shape sh = make_shape(S, H, KV, D, causal, window);
  return dispatch<Fwd>(D, dtype, q, k, v, o, lse, B, sh, stream);
}

// B9's dq (B, S, H, D) from q, k, v, dO (B, S, H, D), lse and
// dsum = rowsum(dO * o), both (B, H, S) fp32.
extern "C" int dlk_flash_attention_dq(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const float* lse, const float* dsum,
                                      void* dq, int B, int S, int H, int KV,
                                      int D, int dtype, int causal, int window,
                                      cudaStream_t stream) {
  const Shape sh = make_shape(S, H, KV, D, causal, window);
  return dispatch<Dq>(D, dtype, q, k, v, dout, lse, dsum, dq, B, sh, stream);
}

// B9's dk, dv (B, S, KV, D), each summed over the KV head's G query heads.
extern "C" int dlk_flash_attention_dkv(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const float* lse, const float* dsum,
                                       void* dk, void* dv, int B, int S, int H,
                                       int KV, int D, int dtype, int causal,
                                       int window, cudaStream_t stream) {
  const Shape sh = make_shape(S, H, KV, D, causal, window);
  return dispatch<Dkv>(D, dtype, q, k, v, dout, lse, dsum, dk, dv, B, sh,
                       stream);
}
