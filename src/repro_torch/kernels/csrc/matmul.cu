// B1: fp32 matrix product with a fused bias + activation epilogue.
//
// Replaces repro/kernels/matmul.py::matmul (_matmul_kernel, _bias_kernel,
// _epilogue), the Pallas MXU kernel that zero-pads A and B to block
// multiples and carries the K sum across grid steps in a VMEM scratch tile.
//
// Bound on the H100: without tensor cores the fp32 FFMA peak is 67 TFLOP/s.
// At large M the operations outweigh the bytes, e.g. (8192,192)x(192,160)
// needs 7.5 us of FLOPs against 3.4 us of HBM traffic at 3.35 TB/s.  The
// main path's products are LeNet's dense layers, 8 x 800 x 500 and
// 8 x 500 x 10 at batch 8: bound by the bytes of B (0.49 us for the first)
// and, in practice, by latency.  No tensor cores and no TF32 here, so the
// result holds fp32 tolerances against a full-fp32 reference.
//
// Two routes, chosen by the wrapper from (M, N, K, SMs)
// (repro_torch/kernels/matmul.py::plan) and passed as `splits`:
//  - splits 0, the tiled kernel, for large M: a shared-memory tiled SGEMM.
//    Each 256-thread block owns a 64x64 output tile and walks K in slabs of
//    16; each thread keeps a 4x4 block of accumulators in registers (rows
//    ty + 16*i, columns tx + 16*j, so that neighbouring threads store
//    neighbouring columns); the bias and the activation are applied to the
//    accumulators before the one store of C.
//  - splits S >= 1, split-K, for M <= 16: the grid is (64-column strip,
//    K slice), S slices of one span each, so that one wave fills the card
//    (8 strips x 32 slices = 256 CTAs at 8 x 800 x 500, 56 at 8 x 500 x
//    10).  A 128-thread CTA stages its M x span slice of A in shared memory
//    (cp.async); thread (kg, cg) of an 8 x 16 grid owns 4 columns and walks
//    the slice's rows kg, kg + 8, ... four at a time, the next four rows of
//    B loaded into registers while these are multiplied, reading B with one
//    16-byte load a row where its stride and alignment allow and with
//    scalar loads otherwise (a transposed weight).  The 8 depth groups are
//    summed in order through shared memory and the partial tile is written
//    to the workspace; a second kernel, launched from the same entry
//    point, sums the S partials in split order, adds the bias and runs the
//    activation.  No float atomics: two runs are bit-equal.
// A and B are read by strides, so a transposed weight view needs no copy,
// and ragged M, N and K edges are masked in the kernels: no input is
// padded or copied.
//
// Not yet done (a later PR): 3xTF32 tensor-core tiles for the large-M
// route (NIN no longer runs B1; its convs are B2's).
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int BM = 64, BN = 64, BK = 16, TM = 4, TN = 4;
constexpr int THREADS = (BM / TM) * (BN / TN);   // 256
constexpr int ROW_STEP = BM / TM;                // 16
constexpr int COL_STEP = BN / TN;                // 16

__global__ void __launch_bounds__(THREADS)
sgemm_bias_act(const float* __restrict__ a, const float* __restrict__ b,
               const float* __restrict__ bias, float* __restrict__ c,
               int M, int N, int K, long long sam, long long sak,
               long long sbk, long long sbn, int act) {
  __shared__ float As[BK][BM + 1];   // A slab stored k-major; +1 breaks bank conflicts on the store
  __shared__ float Bs[BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % COL_STEP;
  const int ty = tid / COL_STEP;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // A slab (BM x BK): consecutive threads walk k, which is contiguous
    // for a row-major A.
#pragma unroll
    for (int r = 0; r < (BM * BK) / THREADS; ++r) {
      const int idx = tid + r * THREADS;
      const int kk = idx % BK, mm = idx / BK;
      const int gm = m0 + mm, gk = k0 + kk;
      As[kk][mm] = (gm < M && gk < K) ? a[gm * sam + gk * sak] : 0.0f;
    }
    // B slab (BK x BN): consecutive threads walk n.
#pragma unroll
    for (int r = 0; r < (BK * BN) / THREADS; ++r) {
      const int idx = tid + r * THREADS;
      const int nn = idx % BN, kk = idx / BN;
      const int gn = n0 + nn, gk = k0 + kk;
      Bs[kk][nn] = (gn < N && gk < K) ? b[gk * sbk + gn * sbn] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = As[kk][ty + i * ROW_STEP];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = Bs[kk][tx + j * COL_STEP];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty + i * ROW_STEP;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + j * COL_STEP;
      if (gn >= N) continue;
      float v = acc[i][j];
      if (bias != nullptr) v += bias[gn];
      c[static_cast<long long>(gm) * N + gn] = dlk_act(v, act);
    }
  }
}

// ---------------------------------------------------------------------------
// split-K for skinny products (M <= SK_MAX_M)
// ---------------------------------------------------------------------------

constexpr int SK_THREADS = 128;
constexpr int SK_COLS = 64;                        // columns a CTA owns
constexpr int SK_GROUPS = SK_THREADS / (SK_COLS / 4);  // 8 depth groups
constexpr int SK_MAX_M = 16;
constexpr int SK_MAX_SPAN = 1024;                  // depth of one split
constexpr int SK_BATCH = 4;                        // rows of B in flight a thread
constexpr int RED_THREADS = 256;

// Columns n .. n + 3 of B's row k (zero past N, and for k >= kend): one
// 16-byte load when VEC (B contiguous along N, rows 16-byte aligned) and
// all four are in range, scalar loads otherwise.
template <bool VEC>
__device__ __forceinline__ float4 b_row4(const float* __restrict__ b, int k,
                                         int kend, int n, int N, long long sbk,
                                         long long sbn) {
  float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (k >= kend) return x;
  const float* row = b + k * sbk;
  if (VEC && n + 3 < N) return __ldg(reinterpret_cast<const float4*>(row + n));
  if (n < N) x.x = row[n * sbn];
  if (n + 1 < N) x.y = row[(n + 1) * sbn];
  if (n + 2 < N) x.z = row[(n + 2) * sbn];
  if (n + 3 < N) x.w = row[(n + 3) * sbn];
  return x;
}

// One CTA: the partial product of columns [n0, n0 + 64) over depth
// [kbeg, kbeg + span) of split blockIdx.y, written to ws (S, M, N).  MR:
// rows held (M rounded up to a power of two).
template <int MR, bool VEC>
__global__ void __launch_bounds__(SK_THREADS)
splitk_partial(const float* __restrict__ a, const float* __restrict__ b,
               float* __restrict__ ws, int M, int N, int K, long long sam,
               long long sak, long long sbk, long long sbn, int span) {
  extern __shared__ float4 sk_smem4[];
  float* r_s = reinterpret_cast<float*>(sk_smem4);   // SK_GROUPS x MR x SK_COLS
  float* a_s = r_s + SK_GROUPS * MR * SK_COLS;       // MR x span
  const int tid = threadIdx.x;
  const int cg = tid % (SK_COLS / 4), kg = tid / (SK_COLS / 4);
  const int n0 = blockIdx.x * SK_COLS, n = n0 + 4 * cg;
  const int kbeg = blockIdx.y * span;
  const int kend = min(K, kbeg + span), len = kend - kbeg;

  for (int i = tid; i < MR * span; i += SK_THREADS) {
    const int m = i / span, kk = i - m * span;
    const bool ok = m < M && kk < len;
    dlk_cp_async4(a_s + i, ok ? a + m * sam + (kbeg + kk) * sak : a, ok);
  }
  dlk_cp_async_commit();
  // this thread's rows kg, kg + 8, ... of the slice, SK_BATCH at a time:
  // the next batch is loaded into registers while this one is multiplied
  float4 next[SK_BATCH];
#pragma unroll
  for (int r = 0; r < SK_BATCH; ++r)
    next[r] = b_row4<VEC>(b, kbeg + kg + r * SK_GROUPS, kend, n, N, sbk, sbn);
  float acc[MR][4];
#pragma unroll
  for (int i = 0; i < MR; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;
  dlk_cp_async_wait<0>();
  __syncthreads();

  for (int k0 = kg; k0 < len; k0 += SK_BATCH * SK_GROUPS) {
    float4 cur[SK_BATCH];
#pragma unroll
    for (int r = 0; r < SK_BATCH; ++r) {
      cur[r] = next[r];
      next[r] = b_row4<VEC>(b, kbeg + k0 + (SK_BATCH + r) * SK_GROUPS, kend, n,
                            N, sbk, sbn);
    }
#pragma unroll
    for (int r = 0; r < SK_BATCH; ++r) {
      const int kk = k0 + r * SK_GROUPS;   // rows past the slice are zero
      if (kk >= len) break;
#pragma unroll
      for (int i = 0; i < MR; ++i) {
        const float av = a_s[i * span + kk];
        acc[i][0] = fmaf(av, cur[r].x, acc[i][0]);
        acc[i][1] = fmaf(av, cur[r].y, acc[i][1]);
        acc[i][2] = fmaf(av, cur[r].z, acc[i][2]);
        acc[i][3] = fmaf(av, cur[r].w, acc[i][3]);
      }
    }
  }

  // the depth groups' sums, added in group order
#pragma unroll
  for (int i = 0; i < MR; ++i)
    *reinterpret_cast<float4*>(r_s + (kg * MR + i) * SK_COLS + 4 * cg) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  __syncthreads();
  for (int j = tid; j < MR * SK_COLS; j += SK_THREADS) {
    const int i = j / SK_COLS, c = j % SK_COLS;
    if (i >= M || n0 + c >= N) continue;
    float sum = r_s[i * SK_COLS + c];
#pragma unroll
    for (int g = 1; g < SK_GROUPS; ++g) sum += r_s[(g * MR + i) * SK_COLS + c];
    ws[(static_cast<long long>(blockIdx.y) * M + i) * N + n0 + c] = sum;
  }
}

// c = act(sum over the S partials in split order + bias), one thread an
// output element.
__global__ void __launch_bounds__(RED_THREADS)
splitk_reduce(const float* __restrict__ ws, const float* __restrict__ bias,
              float* __restrict__ c, int M, int N, int splits, int act) {
  const long long mn = static_cast<long long>(M) * N;
  const long long i = static_cast<long long>(blockIdx.x) * RED_THREADS + threadIdx.x;
  if (i >= mn) return;
  float sum = ws[i];
#pragma unroll 16
  for (int s = 1; s < splits; ++s) sum += ws[s * mn + i];
  if (bias != nullptr) sum += bias[i % N];
  c[i] = dlk_act(sum, act);
}

size_t splitk_smem(int mr, int span) {
  return sizeof(float) * (static_cast<size_t>(SK_GROUPS) * mr * SK_COLS +
                          static_cast<size_t>(mr) * span);
}

template <int MR, bool VEC>
int launch_splitk(const float* a, const float* b, float* ws, int M, int N,
                  int K, long long sam, long long sak, long long sbk,
                  long long sbn, int splits, int span, cudaStream_t stream) {
  auto kern = splitk_partial<MR, VEC>;
  static DlkSmemOnce once;
  if (int err = dlk_prepare_smem(kern, splitk_smem(MR, SK_MAX_SPAN), once))
    return err;
  const dim3 grid((N + SK_COLS - 1) / SK_COLS, splits);
  kern<<<grid, SK_THREADS, splitk_smem(MR, span), stream>>>(
      a, b, ws, M, N, K, sam, sak, sbk, sbn, span);
  return dlk_last_error();
}

template <bool VEC>
int dispatch_splitk(const float* a, const float* b, float* ws, int M, int N,
                    int K, long long sam, long long sak, long long sbk,
                    long long sbn, int splits, int span, cudaStream_t s) {
  if (M <= 1) return launch_splitk<1, VEC>(a, b, ws, M, N, K, sam, sak, sbk, sbn, splits, span, s);
  if (M <= 2) return launch_splitk<2, VEC>(a, b, ws, M, N, K, sam, sak, sbk, sbn, splits, span, s);
  if (M <= 4) return launch_splitk<4, VEC>(a, b, ws, M, N, K, sam, sak, sbk, sbn, splits, span, s);
  if (M <= 8) return launch_splitk<8, VEC>(a, b, ws, M, N, K, sam, sak, sbk, sbn, splits, span, s);
  return launch_splitk<16, VEC>(a, b, ws, M, N, K, sam, sak, sbk, sbn, splits, span, s);
}

}  // namespace

// c (M, N) row-major contiguous = act(a @ b + bias); a read as
// a[m * sam + k * sak], b as b[k * sbk + n * sbn]; bias may be null.
// splits 0: the tiled kernel (ws unused, may be null).  splits S >= 1:
// split-K for M <= 16, K >= 1, K cut into S slices of ceil(K / S) <= 1024
// rows, each non-empty; the partials go through ws (S x M x N floats).
extern "C" int dlk_matmul_f32(const float* a, const float* b, const float* bias,
                              float* c, float* ws, int M, int N, int K,
                              long long sam, long long sak, long long sbk,
                              long long sbn, int act, int splits,
                              cudaStream_t stream) {
  if (splits == 0) {
    const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
    sgemm_bias_act<<<grid, THREADS, 0, stream>>>(a, b, bias, c, M, N, K, sam,
                                                 sak, sbk, sbn, act);
    return dlk_last_error();
  }
  const int span = K > 0 && splits > 0 ? (K + splits - 1) / splits : 0;
  if (splits < 0 || M < 1 || M > SK_MAX_M || K < 1 || ws == nullptr ||
      span > SK_MAX_SPAN || (splits - 1) * span >= K)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = sbn == 1 && sbk % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(b) % 16 == 0;
  const int err = vec ? dispatch_splitk<true>(a, b, ws, M, N, K, sam, sak, sbk,
                                              sbn, splits, span, stream)
                      : dispatch_splitk<false>(a, b, ws, M, N, K, sam, sak,
                                               sbk, sbn, splits, span, stream);
  if (err) return err;
  const long long mn = static_cast<long long>(M) * N;
  splitk_reduce<<<static_cast<unsigned>((mn + RED_THREADS - 1) / RED_THREADS),
                  RED_THREADS, 0, stream>>>(ws, bias, c, M, N, splits, act);
  return dlk_last_error();
}
