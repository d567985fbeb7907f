// B10: the chunked RWKV-6 WKV from a zero state (prefill, and the forward
// without grad): r, k, v (B, T, H, N) of one dtype, fp32 or bf16, the
// decay w (B, T, H, N) fp32 or in r's dtype (a bf16 RWKV-6 keeps w in
// fp32: bf16 would round a decay near 1 to 1), and the bonus u (H, N)
// fp32 -> out (B, T, H, N) in r's dtype and the final state (B, H, N, N)
// fp32, for head sizes N 32 and 64.  Each input is read in its own dtype
// and widened to fp32, as the Pallas kernel casts each to fp32.
//
// Replaces repro/kernels/rwkv6_chunk.py::rwkv6_chunked (body _wkv_kernel).
// On the TPU the grid (B, H, T/16) walks the chunks of one head in order
// and carries the N x N state in VMEM scratch from one grid step to the
// next; its wrapper pads T to a multiple of 16 with w = 1 by a copy.
//
// Per 16-token chunk, with cum the column cumsum of log w over the chunk
// (cum_{-1} = 0):
//   att[i, j] = sum_n r_in k_jn exp(clip(cum_{i-1,n} - cum_jn, -60, 0))
//               for j < i, and sum_n r_in k_in u_n on the diagonal;
//   out_i     = sum_j<=i att[i, j] v_j + (r_i * exp(cum_{i-1})) . S;
//   S[n, m]  <- exp(cum_last_n) S[n, m]
//               + sum_j k_jn exp(cum_last_n - cum_jn) v_jm.
// S[n, m]: n is the key dimension (scaled by the decay), m the value one.
//
// Bound on the H100: the bytes at the shapes the model gives it (four
// inputs read once, out and state written once: 4.78 us at 1 x 300 x 40 x
// 64 fp32); the operations (~16 a byte at N 64) sit under the fp32 ridge.
//
// Design: two passes.  Only S ties one chunk to the next, so
//  1. wkv_prepare, one CTA of 8N threads a (chunk, head, batch), all in
//     parallel, forms the chunk's state-independent terms and writes them
//     to a workspace record (16.3 KB at N 64; the wrapper keeps up to 64
//     MB of records a stream and allocates larger calls' per call): log2 w (fp32 log2f, 0 past
//     T), its cumsum in fp64; r decayed to each token's start, k decayed
//     to the chunk's end and the chunk's decay (fp32 exp2f of the fp64
//     exponent rounded once); att, whose pair exponents are formed from
//     the cumsum split into fp32 hi + lo (cum_{i-1} - cum_j to within an
//     fp32 rounding of the difference itself, never of cum, which reaches
//     -1385 in log2 units where w = 0), clipped to [-60 log2 e, 0], taken
//     by exp2f, widened to fp64 by integer operations, and each term r k
//     fac formed and summed in fp64 as an adjacent-pair tree over N (fp32
//     sums put att ~1e-5 off, at the bar); then att . v in fp64 (even and
//     odd j apart) for every value column.  Rows p and 15 - p share a
//     unit of 17 pairs; the pair index comes from the thread index, not a
//     search; a step's 4 columns come in 16-byte shared-memory reads;
//  2. wkv_scan, one CTA of 8 MB threads a (block of MB value columns,
//     head, batch): column m of out and of S depends on column m of v
//     alone, given the records, so MB = N / 2 splits a head in two (the
//     fastest of 8, 16, 32 and 64 columns at 1 x 300 and 8 x 2048 x 40 x
//     64 on the H100, PERF.md; fixed, not a launch argument).
//     A three-stage cp.async ring brings each chunk's decays, the own
//     columns of its att . v and of v (16-byte copies; plain loads where
//     v is not 16-byte aligned) while the previous chunk computes.
//     Thread (g, m), g < 8 key-row groups, keeps N / 8 state entries in
//     fp32 registers, adds its rows' share of (r decayed) . S into 16 FFMA
//     chains of N / 8, and updates its entries by 16-term FFMA chains;
//     out = att . v + the 8 groups' partials (an adjacent-pair tree in
//     fp64), rounded once; only rows < T are written.
// No fp64 exp or log; no float atomics; every sum's order is fixed by N
// alone, so the result is bit-equal across reruns and whatever B is.  Rows past T read as zeros (no padding copy).
//
// Not yet done: the scan's products on tensor cores; the first pass is
// issue-bound (index arithmetic, the row pair's selects) and its records
// go through L2 and, at 8 x 2048 x 40 x 64 (682 MB), HBM.
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int C = 16;                      // tokens per chunk
constexpr int G = 8;                       // key-row groups of the scan
constexpr int PAIRS = C * (C + 1) / 2;     // 136 pairs j <= i
constexpr int STEP_GROUPS = 4;             // a unit's 17 steps dealt 5, 4, 4, 4
constexpr int STEPS_PER_GROUP = 5;
constexpr int STAGES = 3;                  // the scan's ring of chunks
constexpr float EXP2_FLOOR = -86.56170245333781f;   // -60 * log2(e)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ int pair_index(int i, int j) { return i * (i + 1) / 2 + j; }

// A normal, positive float widened to double exactly, by integer operations
// (the INT pipe), sparing the conversion unit that exp2f also uses.
__device__ __forceinline__ double widen(float x) {
  const unsigned f = __float_as_uint(x);
  return __hiloint2double(static_cast<int>((f >> 3) + 0x38000000u), static_cast<int>(f << 29));
}

// What the first pass leaves for the scan, one record a (b, h, chunk).
template <int N>
struct alignas(16) Rec {
  float rdec[C][N];                 // r decayed to each token's start
  float kdec[C][N];                 // k decayed to the chunk's end
  float dl[N];                      // the chunk's decay
  double intra[C][N];               // sum_j<=i att[i, j] v_j
};

// ---------------------------------------------------------------------------
// pass 1: one CTA of 8N threads a (chunk, head, batch)
// ---------------------------------------------------------------------------

template <int N, typename T, typename TW>
struct PrepSmem {
  static constexpr int SLICES = N / 4;
  alignas(16) T tile[3][C][N];      // r, k, v
  alignas(16) TW wt[C][N];          // w, in its own dtype
  alignas(16) float hi[C + 1][N];   // cumx[i] = cum_{i-1}, as hi + lo
  alignas(16) float lo[C + 1][N];
  alignas(16) double kd[C][N];      // k in fp64
  union {
    double lwd[C][N];               // log2 w (0 past T), until the cumsum
    double attp[SLICES][PAIRS];     // then att over each 4-column slice
  };
  double att[PAIRS];                // att over all N columns
};

template <int N, typename T, typename TW>
__global__ void __launch_bounds__(8 * N, 65536 / (8 * N * 64))
wkv_prepare(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const TW* __restrict__ w,
            const float* __restrict__ u, Rec<N>* __restrict__ ws, int Tlen,
            int H, int vec) {
  using Sm = PrepSmem<N, T, TW>;
  constexpr int THREADS = 8 * N;
  constexpr int SLICES = Sm::SLICES;
  constexpr int ROWS = C * N / THREADS;   // 2 rows a thread in the cumsum
  static_assert(THREADS == (C / 2) * STEP_GROUPS * SLICES, "att units");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Sm& s = *reinterpret_cast<Sm*>(smem_raw);
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x, tid = threadIdx.x, t0 = c * C;
  const size_t row = static_cast<size_t>(H) * N;
  const size_t base = (static_cast<size_t>(b) * Tlen + t0) * row +
                      static_cast<size_t>(h) * N;             // (b, t0, h, 0)
  Rec<N>& rec = ws[(static_cast<size_t>(b) * H + h) * nc + c];

  // stage r, k, v and w of the chunk, each row in its own dtype (16-byte
  // copies: 16 / sizeof elements); rows past T land as zeros
  if (vec) {
    constexpr int EPC = 16 / sizeof(T), CPR = N / EPC;
    for (int idx = tid; idx < 3 * C * CPR; idx += THREADS) {
      const int x = idx / (C * CPR), rem = idx % (C * CPR);
      const int i = rem / CPR, cp = rem % CPR;
      const T* src = x == 0 ? r : x == 1 ? k : v;
      const bool ok = t0 + i < Tlen;
      dlk_cp_async16(reinterpret_cast<float*>(&s.tile[x][i][cp * EPC]),
                     reinterpret_cast<const float*>(
                         src + base + static_cast<size_t>(ok ? i : 0) * row + cp * EPC), ok);
    }
    constexpr int WEPC = 16 / sizeof(TW), WCPR = N / WEPC;
    for (int idx = tid; idx < C * WCPR; idx += THREADS) {
      const int i = idx / WCPR, cp = idx % WCPR;
      const bool ok = t0 + i < Tlen;
      dlk_cp_async16(reinterpret_cast<float*>(&s.wt[i][cp * WEPC]),
                     reinterpret_cast<const float*>(
                         w + base + static_cast<size_t>(ok ? i : 0) * row + cp * WEPC), ok);
    }
    dlk_cp_async_commit();
    dlk_cp_async_wait<0>();
  } else {
    for (int idx = tid; idx < 3 * C * N; idx += THREADS) {
      const int x = idx / (C * N), rem = idx % (C * N);
      const int i = rem / N, n = rem % N;
      const T* src = x == 0 ? r : x == 1 ? k : v;
      s.tile[x][i][n] = t0 + i < Tlen ? src[base + static_cast<size_t>(i) * row + n]
                                      : from_f<T>(0.0f);
    }
    for (int idx = tid; idx < C * N; idx += THREADS) {
      const int i = idx / N, n = idx % N;
      s.wt[i][n] = t0 + i < Tlen ? w[base + static_cast<size_t>(i) * row + n]
                                 : from_f<TW>(0.0f);
    }
  }
  __syncthreads();
  // log2 w in fp32, 0 past T
  for (int idx = tid; idx < C * N; idx += THREADS) {
    const int i = idx / N, n = idx % N;
    s.lwd[i][n] = t0 + i < Tlen
        ? static_cast<double>(log2f(fminf(fmaxf(to_f(s.wt[i][n]), 1e-26f), 1.0f)))
        : 0.0;
  }
  __syncthreads();
  // thread (gi, n): the fp64 cumsum of column n, then rows ROWS*gi ..
  {
    const int n = tid % N, i0 = ROWS * (tid / N);
    double acc = 0.0, prev = 0.0, cum[ROWS];
#pragma unroll
    for (int i = 0; i < C; ++i) {
      if (i == i0) prev = acc;                // cum_{i0-1}
      acc += s.lwd[i][n];
#pragma unroll
      for (int e = 0; e < ROWS; ++e)
        if (i == i0 + e) cum[e] = acc;
    }
    const double cl = acc;
#pragma unroll
    for (int e = 0; e < ROWS; ++e) {
      const int i = i0 + e;
      const float kv = to_f(s.tile[1][i][n]);
      rec.rdec[i][n] = to_f(s.tile[0][i][n]) *
                       exp2f(static_cast<float>(e == 0 ? prev : cum[e - 1]));
      rec.kdec[i][n] = kv * exp2f(static_cast<float>(cl - cum[e]));
      const float hv = static_cast<float>(cum[e]);
      s.hi[i + 1][n] = hv;
      s.lo[i + 1][n] = static_cast<float>(cum[e] - static_cast<double>(hv));
      s.kd[i][n] = kv;
    }
    if (i0 == 0) {
      rec.dl[n] = exp2f(static_cast<float>(cl));
      s.hi[0][n] = s.lo[0][n] = 0.0f;
    }
  }
  __syncthreads();
  // att over each 4-column slice: unit (row pair rp, step group sg, slice
  // sl) takes rows rp and C-1-rp, whose 17 pairs are its steps; a step's
  // 4 columns come in 16-byte reads
  {
    const int sl = tid % SLICES;
    const int sg = (tid / SLICES) % STEP_GROUPS;
    const int rp = tid / (SLICES * STEP_GROUPS);
    const int step0 = sg == 0 ? 0 : 1 + 4 * sg;           // 0, 5, 9, 13
    const int nsteps = sg == 0 ? 5 : 4;
    const int ra = rp, rb = C - 1 - rp, n0 = 4 * sl;
    double rda[4], rdb[4], ud[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      rda[e] = to_f(s.tile[0][ra][n0 + e]);
      rdb[e] = to_f(s.tile[0][rb][n0 + e]);
      ud[e] = u[h * N + n0 + e];
    }
    const float4 ha = *reinterpret_cast<const float4*>(&s.hi[ra][n0]);
    const float4 la = *reinterpret_cast<const float4*>(&s.lo[ra][n0]);
    const float4 hb = *reinterpret_cast<const float4*>(&s.hi[rb][n0]);
    const float4 lb = *reinterpret_cast<const float4*>(&s.lo[rb][n0]);
    double part[STEPS_PER_GROUP];
    int pi[STEPS_PER_GROUP];
#pragma unroll
    for (int it = 0; it < STEPS_PER_GROUP; ++it) {
      const int t = step0 + (it < nsteps ? it : 0);
      const bool first = t <= rp;
      const int i = first ? ra : rb;
      const int j = first ? t : t - rp - 1;
      pi[it] = pair_index(i, j);
      const float4 hj = *reinterpret_cast<const float4*>(&s.hi[j + 1][n0]);
      const float4 lj = *reinterpret_cast<const float4*>(&s.lo[j + 1][n0]);
      const double2 k01 = *reinterpret_cast<const double2*>(&s.kd[j][n0]);
      const double2 k23 = *reinterpret_cast<const double2*>(&s.kd[j][n0 + 2]);
      const float hi4[4] = {first ? ha.x : hb.x, first ? ha.y : hb.y,
                            first ? ha.z : hb.z, first ? ha.w : hb.w};
      const float lo4[4] = {first ? la.x : lb.x, first ? la.y : lb.y,
                            first ? la.z : lb.z, first ? la.w : lb.w};
      const float hj4[4] = {hj.x, hj.y, hj.z, hj.w};
      const float lj4[4] = {lj.x, lj.y, lj.z, lj.w};
      const double kj4[4] = {k01.x, k01.y, k23.x, k23.y};
      double term[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = __fadd_rn(__fsub_rn(hi4[e], hj4[e]), __fsub_rn(lo4[e], lj4[e]));
        const double fac = j == i ? ud[e] : widen(exp2f(fminf(fmaxf(x, EXP2_FLOOR), 0.0f)));
        term[e] = __dmul_rn(__dmul_rn(first ? rda[e] : rdb[e], kj4[e]), fac);
      }
      part[it] = (term[0] + term[1]) + (term[2] + term[3]);
    }
#pragma unroll
    for (int it = 0; it < STEPS_PER_GROUP; ++it)
      if (it < nsteps) s.attp[sl][pi[it]] = part[it];
  }
  __syncthreads();
  // the slices' adjacent-pair tree: att over all N columns
  for (int p = tid; p < PAIRS; p += THREADS) {
    double x[SLICES];
#pragma unroll
    for (int a = 0; a < SLICES; ++a) x[a] = s.attp[a][p];
#pragma unroll
    for (int len = SLICES; len > 1; len >>= 1)
#pragma unroll
      for (int a = 0; a < len / 2; ++a) x[a] = x[2 * a] + x[2 * a + 1];
    s.att[p] = x[0];
  }
  __syncthreads();
  // intra = att . v for every value column (even and odd j apart, fp64):
  // thread (i, m) takes rows i and i + C/2 of column m
  {
    const int m = tid % N, i = tid / N;
    static_assert(THREADS / N == C / 2, "rows a thread");
    double vd[C];
#pragma unroll
    for (int j = 0; j < C; ++j) vd[j] = to_f(s.tile[2][j][m]);
#pragma unroll
    for (int oo = 0; oo < 2; ++oo) {
      const int io = i + oo * (C / 2);
      const double* ai = s.att + pair_index(io, 0);
      double a0 = 0.0, a1 = 0.0;
#pragma unroll
      for (int j = 0; j < C; j += 2) {
        if (j <= io) a0 = fma(ai[j], vd[j], a0);
        if (j + 1 <= io) a1 = fma(ai[j + 1], vd[j + 1], a1);
      }
      rec.intra[io][m] = a0 + a1;
    }
  }
}

// ---------------------------------------------------------------------------
// pass 2: the scan, one CTA of 8 MB threads a (value block, head, batch)
// ---------------------------------------------------------------------------

template <int N, int MB, typename T>
struct ScanSmem {
  alignas(16) float rdec[STAGES][C][N];
  alignas(16) float kdec[STAGES][C][N];
  alignas(16) float dl[STAGES][N];
  alignas(16) double intra[STAGES][C][MB];
  alignas(16) T v[STAGES][C][MB];
  float part[G][C][MB];             // (r decayed) . S over each key-row group
};

template <int N, int MB, typename T>
__global__ void __launch_bounds__(G * MB)
wkv_scan(const T* __restrict__ v, const Rec<N>* __restrict__ ws,
         T* __restrict__ out, float* __restrict__ state, int Tlen, int H, int vec) {
  using Sm = ScanSmem<N, MB, T>;
  constexpr int THREADS = G * MB;
  constexpr int NG = N / G;             // key rows a thread owns
  static_assert(NG % 4 == 0 && THREADS / MB == C / 2, "shape");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Sm& s = *reinterpret_cast<Sm*>(smem_raw);
  const int q = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int m0 = q * MB, tid = threadIdx.x;
  const int nc = (Tlen + C - 1) / C;
  const size_t row = static_cast<size_t>(H) * N;
  const size_t base = static_cast<size_t>(b) * Tlen * row +
                      static_cast<size_t>(h) * N + m0;         // (b, 0, h, m0)
  const Rec<N>* recs = ws + (static_cast<size_t>(b) * H + h) * nc;

  // chunk c's decays (all N columns), its intra and v (own columns)
  auto load = [&](int c) {
    const int st = c % STAGES, t0 = c * C;
    const Rec<N>& rc = recs[c];
    constexpr int DW = C * N / 4;                 // 16-byte copies of rdec
    for (int idx = tid; idx < 2 * DW + N / 4; idx += THREADS) {
      float* dst = idx < DW ? &s.rdec[st][0][0] + 4 * idx
                 : idx < 2 * DW ? &s.kdec[st][0][0] + 4 * (idx - DW)
                                : &s.dl[st][0] + 4 * (idx - 2 * DW);
      const float* src = idx < DW ? &rc.rdec[0][0] + 4 * idx
                       : idx < 2 * DW ? &rc.kdec[0][0] + 4 * (idx - DW)
                                      : &rc.dl[0] + 4 * (idx - 2 * DW);
      dlk_cp_async16(dst, src, true);
    }
    constexpr int IW = MB / 2;                    // 16-byte copies a row
    for (int idx = tid; idx < C * IW; idx += THREADS) {
      const int i = idx / IW, cp = idx % IW;
      dlk_cp_async16(reinterpret_cast<float*>(&s.intra[st][i][2 * cp]),
                     reinterpret_cast<const float*>(&rc.intra[i][m0 + 2 * cp]), true);
    }
    if (vec) {
      constexpr int EPC = 16 / sizeof(T), CPR = MB / EPC;
      for (int idx = tid; idx < C * CPR; idx += THREADS) {
        const int i = idx / CPR, cp = idx % CPR;
        const bool ok = t0 + i < Tlen;
        dlk_cp_async16(reinterpret_cast<float*>(&s.v[st][i][cp * EPC]),
                       reinterpret_cast<const float*>(
                           v + base + static_cast<size_t>(ok ? t0 + i : 0) * row + cp * EPC),
                       ok);
      }
    } else {
      for (int idx = tid; idx < C * MB; idx += THREADS) {
        const int i = idx / MB, mm = idx % MB;
        s.v[st][i][mm] = t0 + i < Tlen ? v[base + static_cast<size_t>(t0 + i) * row + mm]
                                       : from_f<T>(0.0f);
      }
    }
    dlk_cp_async_commit();
  };

  const int cm = tid % MB, cgr = tid / MB, nb = cgr * NG;
  float S[NG];
#pragma unroll
  for (int e = 0; e < NG; ++e) S[e] = 0.0f;
  load(0);
  if (nc > 1) load(1); else dlk_cp_async_commit();
  for (int c = 0; c < nc; ++c) {
    const int st = c % STAGES, t0 = c * C;
    dlk_cp_async_wait<1>();
    __syncthreads();                      // chunk c landed; chunk c - 1 done
    if (c + 2 < nc) load(c + 2); else dlk_cp_async_commit();
    // (r decayed) . S over the thread's key rows (from the state before
    // chunk c), then the state update
    {
      float acc[C], kv[NG], vv[C];
#pragma unroll
      for (int j = 0; j < C; ++j) vv[j] = to_f(s.v[st][j][cm]);
#pragma unroll
      for (int i = 0; i < C; ++i) {
        acc[i] = 0.0f;
#pragma unroll
        for (int e4 = 0; e4 < NG; e4 += 4) {
          const float4 rv = *reinterpret_cast<const float4*>(&s.rdec[st][i][nb + e4]);
          acc[i] = fmaf(rv.x, S[e4], acc[i]);
          acc[i] = fmaf(rv.y, S[e4 + 1], acc[i]);
          acc[i] = fmaf(rv.z, S[e4 + 2], acc[i]);
          acc[i] = fmaf(rv.w, S[e4 + 3], acc[i]);
        }
      }
#pragma unroll
      for (int e = 0; e < NG; ++e) kv[e] = 0.0f;
#pragma unroll
      for (int j = 0; j < C; ++j) {
#pragma unroll
        for (int e4 = 0; e4 < NG; e4 += 4) {
          const float4 kq = *reinterpret_cast<const float4*>(&s.kdec[st][j][nb + e4]);
          kv[e4] = fmaf(kq.x, vv[j], kv[e4]);
          kv[e4 + 1] = fmaf(kq.y, vv[j], kv[e4 + 1]);
          kv[e4 + 2] = fmaf(kq.z, vv[j], kv[e4 + 2]);
          kv[e4 + 3] = fmaf(kq.w, vv[j], kv[e4 + 3]);
        }
      }
#pragma unroll
      for (int e = 0; e < NG; ++e) S[e] = fmaf(s.dl[st][nb + e], S[e], kv[e]);
#pragma unroll
      for (int i = 0; i < C; ++i) s.part[cgr][i][cm] = acc[i];
    }
    __syncthreads();
    // out = intra + the groups' partials (an adjacent-pair tree, fp64),
    // rounded once; thread (i, m) takes rows i and i + C/2; rows < T
    {
      const int i = tid / MB, mm = tid % MB;
#pragma unroll
      for (int oo = 0; oo < 2; ++oo) {
        const int io = i + oo * (C / 2);
        double pg[G];
#pragma unroll
        for (int g = 0; g < G; ++g) pg[g] = s.part[g][io][mm];
#pragma unroll
        for (int len = G; len > 1; len >>= 1)
#pragma unroll
          for (int a = 0; a < len / 2; ++a) pg[a] = pg[2 * a] + pg[2 * a + 1];
        if (t0 + io < Tlen)
          out[base + static_cast<size_t>(t0 + io) * row + mm] =
              from_f<T>(static_cast<float>(s.intra[st][io][mm] + pg[0]));
      }
    }
  }
  dlk_cp_async_wait<0>();
  float* st = state + (static_cast<size_t>(b) * H + h) * N * N + m0 + cm;
#pragma unroll
  for (int e = 0; e < NG; ++e) st[static_cast<size_t>(nb + e) * N] = S[e];
}

template <int N, typename T, typename TW>
int launch(const void* r, const void* k, const void* v, const void* w,
           const float* u, void* out, float* state, void* ws, int B, int Tlen,
           int H, int vec, cudaStream_t stream) {
  constexpr int MB = N / 2;             // value columns a scan CTA
  const int nc = (Tlen + C - 1) / C;
  auto prep = wkv_prepare<N, T, TW>;
  auto scan = wkv_scan<N, MB, T>;
  static DlkSmemOnce prep_once, scan_once;
  const size_t prep_smem = sizeof(PrepSmem<N, T, TW>),
               scan_smem = sizeof(ScanSmem<N, MB, T>);
  if (int err = dlk_prepare_smem(prep, prep_smem, prep_once)) return err;
  if (int err = dlk_prepare_smem(scan, scan_smem, scan_once)) return err;
  Rec<N>* recs = static_cast<Rec<N>*>(ws);
  prep<<<dim3(nc, H, B), 8 * N, prep_smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const TW*>(w), u, recs, Tlen, H, vec);
  if (int err = dlk_last_error()) return err;
  scan<<<dim3(N / MB, H, B), G * MB, scan_smem, stream>>>(
      static_cast<const T*>(v), recs, static_cast<T*>(out), state, Tlen, H, vec);
  return dlk_last_error();
}

template <int N>
int by_dtype(int dtype, int wdtype, const void* r, const void* k, const void* v,
             const void* w, const float* u, void* out, float* state, void* ws,
             int B, int Tlen, int H, int vec, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  if (dtype == 0 && wdtype == 0)
    return launch<N, float, float>(r, k, v, w, u, out, state, ws, B, Tlen, H, vec,
                                   stream);
  if (dtype == 1 && wdtype == 1)
    return launch<N, bf16, bf16>(r, k, v, w, u, out, state, ws, B, Tlen, H, vec,
                                 stream);
  if (dtype == 1 && wdtype == 0)
    return launch<N, bf16, float>(r, k, v, w, u, out, state, ws, B, Tlen, H, vec,
                                  stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 fp32, 1 bf16 (r, k, v and out); wdtype: w's, 0 fp32 or dtype
// itself; u and state are fp32.  ws: B * H * ceil(T / 16) records of
// dlk_rwkv6_record_bytes(N) bytes (fp32 and fp64 fields whatever the
// inputs' dtypes), 16-byte aligned (written before they are read: no
// memset).  vec: 1 when r, k, v and w start on 16 bytes (16-byte copies,
// 16 / sizeof elements of each input's own dtype).
extern "C" int dlk_rwkv6_chunked(const void* r, const void* k, const void* v,
                                 const void* w, const float* u, void* out,
                                 float* state, void* ws, int B, int T, int H,
                                 int N, int dtype, int wdtype, int vec,
                                 cudaStream_t stream) {
  if (B < 1 || T < 1 || H < 1 || B > 65535 || H > 65535 || !ws)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 32)
    return by_dtype<32>(dtype, wdtype, r, k, v, w, u, out, state, ws, B, T, H, vec,
                        stream);
  if (N == 64)
    return by_dtype<64>(dtype, wdtype, r, k, v, w, u, out, state, ws, B, T, H, vec,
                        stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The bytes of one (b, h, chunk) record of the workspace.
extern "C" int dlk_rwkv6_record_bytes(int N) {
  return N == 32 ? static_cast<int>(sizeof(Rec<32>))
                 : N == 64 ? static_cast<int>(sizeof(Rec<64>)) : 0;
}
