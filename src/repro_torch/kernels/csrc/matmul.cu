// B1: fp32 matrix product with a fused bias + activation epilogue.
//
// Replaces repro/kernels/matmul.py::matmul (_matmul_kernel, _bias_kernel,
// _epilogue), the Pallas MXU kernel that zero-pads A and B to block
// multiples and carries the K sum across grid steps in a VMEM scratch tile.
//
// Bound on the H100: without tensor cores the fp32 FFMA peak is 67 TFLOP/s.
// At most of NIN's shapes the operations outweigh the bytes, e.g. at batch
// 8, (8192,192)x(192,160) needs 7.5 us of FLOPs against 3.4 us of HBM
// traffic at 3.35 TB/s; the last 1x1 conv (N = 10) is bound by bytes.
// No tensor cores and no TF32 here, so the result holds fp32 tolerances
// against a full-fp32 reference.
//
// Design: a shared-memory tiled SGEMM.  Each 256-thread block owns a 64x64
// output tile and walks K in slabs of 16; each thread keeps a 4x4 block of
// accumulators in registers (rows ty + 16*i, columns tx + 16*j, so that
// neighbouring threads store neighbouring columns).  A and B are read by
// strides, so a transposed weight view needs no copy.  Ragged M, N and K
// edges are masked in the kernel, so no input is padded or copied.  The
// bias and the activation are applied to the accumulators before the one
// store of C.
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

}  // namespace

// c (M, N) row-major contiguous = act(a @ b + bias); a read as
// a[m * sam + k * sak], b as b[k * sbk + n * sbn]; bias may be null.
extern "C" int dlk_matmul_f32(const float* a, const float* b, const float* bias,
                              float* c, int M, int N, int K, long long sam,
                              long long sak, long long sbk, long long sbn,
                              int act, cudaStream_t stream) {
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  sgemm_bias_act<<<grid, THREADS, 0, stream>>>(a, b, bias, c, M, N, K, sam,
                                               sak, sbk, sbn, act);
  return dlk_last_error();
}
