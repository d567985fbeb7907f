// B11: int8 (M, K) @ int8 (K, N) into int32, then per-row and per-column
// dequantization scales, out fp32 (M, N).
//
// Replaces repro/kernels/int8_matmul.py::int8_matmul (_int8_kernel), the
// Pallas kernel that pads both operands to 256 x 512 x 256 blocks, keeps an
// int32 accumulator in VMEM across a sequential K grid axis and scales it
// once in its last K step.
//
// Bound on the H100: 2MKN operations against (MK + KN) bytes in and 4MN
// out.  At a decode batch (M 8) the weight bytes bound it; at M in the
// hundreds and more the int8 tensor cores (1979 TOPS dense) do.  This first
// kernel uses dp4a on the CUDA cores, not the tensor cores (mma.sync IMMA
// and wgmma are later work), so it cannot reach the compute bound.
//
// Design: one 256-thread CTA per 64 x 64 output tile.  The K loop runs
// inside the CTA, 64 at a time through shared memory: A as 64 rows of 16
// 32-bit words (four consecutive k per word), B transposed the same way (a
// column's four consecutive k packed in one word), rows padded to 17 words
// so that neither read below conflicts on a bank.  Each thread keeps 4 x 4
// int32 sums and adds four products a step with __dp4a.  Edges in M, N and
// K load as zero, so nothing is padded or copied outside the kernel.  The
// epilogue rounds the exact int32 sum to fp32 and multiplies by the row
// scale, then the column scale, in the plain version's order.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int TILE = 64;         // output rows and columns per CTA
constexpr int TK = 64;           // k per stage
constexpr int WORDS = TK / 4;    // packed words per row and stage
constexpr int PAD = WORDS + 1;   // row pitch in shared memory, in words
constexpr int THREADS = 256;

__device__ __forceinline__ int pack4(int8_t b0, int8_t b1, int8_t b2, int8_t b3) {
  return static_cast<int>((static_cast<uint32_t>(static_cast<uint8_t>(b0))) |
                          (static_cast<uint32_t>(static_cast<uint8_t>(b1)) << 8) |
                          (static_cast<uint32_t>(static_cast<uint8_t>(b2)) << 16) |
                          (static_cast<uint32_t>(static_cast<uint8_t>(b3)) << 24));
}

__global__ void __launch_bounds__(THREADS)
int8_matmul_tiles(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
                  const float* __restrict__ a_scale,
                  const float* __restrict__ b_scale, float* __restrict__ out,
                  int M, int N, int K) {
  __shared__ int As[TILE][PAD];   // As[m][w]: a[m, k0 + 4w .. 4w + 3]
  __shared__ int Bs[TILE][PAD];   // Bs[n][w]: b[k0 + 4w .. 4w + 3, n]
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const long long m0 = static_cast<long long>(blockIdx.y) * TILE;
  const long long n0 = static_cast<long long>(blockIdx.x) * TILE;
  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += TK) {
    // A: word w of row r; neighbouring threads take neighbouring words
#pragma unroll
    for (int it = 0; it < TILE * WORDS / THREADS; ++it) {
      const int idx = tid + it * THREADS;
      const int r = idx / WORDS, w = idx % WORDS;
      const long long m = m0 + r;
      int8_t v[4] = {0, 0, 0, 0};
      if (m < M) {
        const int8_t* row = a + m * K;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int k = k0 + 4 * w + q;
          if (k < K) v[q] = row[k];
        }
      }
      As[r][w] = pack4(v[0], v[1], v[2], v[3]);
    }
    // B transposed: column c, word w; neighbouring threads take
    // neighbouring columns of the same four rows
#pragma unroll
    for (int it = 0; it < TILE * WORDS / THREADS; ++it) {
      const int idx = tid + it * THREADS;
      const int c = idx % TILE, w = idx / TILE;
      const long long n = n0 + c;
      int8_t v[4] = {0, 0, 0, 0};
      if (n < N) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const long long k = k0 + 4 * w + q;
          if (k < K) v[q] = b[k * N + n];
        }
      }
      Bs[c][w] = pack4(v[0], v[1], v[2], v[3]);
    }
    __syncthreads();
#pragma unroll
    for (int w = 0; w < WORDS; ++w) {
      int av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[ty + 16 * i][w];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[tx + 16 * j][w];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + ty + 16 * i;
    if (m >= M) continue;
    const float sa = a_scale[m];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long n = n0 + tx + 16 * j;
      if (n < N) {
        const float x = __fmul_rn(static_cast<float>(acc[i][j]), sa);
        out[m * N + n] = __fmul_rn(x, b_scale[n]);
      }
    }
  }
}

}  // namespace

// out (M, N) fp32 = float(a (M, K) int8 @ b (K, N) int8, summed in int32)
// * a_scale[m] * b_scale[n]; a, b and out row-major and contiguous.
extern "C" int dlk_int8_matmul(const int8_t* a, const int8_t* b,
                               const float* a_scale, const float* b_scale,
                               float* out, int M, int N, int K,
                               cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((N + TILE - 1) / TILE),
                  static_cast<unsigned>((M + TILE - 1) / TILE));
  int8_matmul_tiles<<<grid, THREADS, 0, stream>>>(a, b, a_scale, b_scale, out,
                                                  M, N, K);
  return dlk_last_error();
}
