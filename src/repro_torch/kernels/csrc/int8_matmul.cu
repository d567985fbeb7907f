// B11: int8 (M, K) @ int8 (K, N) into int32, then per-row and per-column
// dequantization scales, out fp32 (M, N).
//
// Replaces repro/kernels/int8_matmul.py::int8_matmul (_int8_kernel), the
// Pallas kernel that pads both operands to 256 x 512 x 256 blocks, keeps an
// int32 accumulator in VMEM across a sequential K grid axis and scales it
// once in its last K step.
//
// Bound on the H100: 2MKN operations against (MK + KN) bytes in and 4MN
// out.  At the Granite-MoE artifact's shapes the bytes bound it (1.39 us at
// 300 x 1536 @ 1536 x 1536, 0.70 us at a decode batch of 8, where the
// 2.36 MB weight is nearly all of it); the int8 tensor cores (1979 TOPS
// dense) would take 0.71 us at M 300.
//
// Design: the int8 tensor cores through mma.sync.m16n8k32.row.col.s32.s8.
// s8.s32 (no .satfinite: an overflowing sum wraps, as the plain int32 sum
// and the TPU's do).  A CTA of 4 warps owns a BM x BN output tile: 16 x 64
// at M <= 16 (a warp 16 x 16), 64 x 64 otherwise (a warp 32 x 32).  K runs
// through a 3-stage cp.async ring, 64 k a stage.
//  - A (M, K) is K-major, as mma's .row A operand wants it: 16-byte copies
//    when K is a multiple of 16 and A starts on 16 bytes, byte loads
//    otherwise; a fragment register is one 32-bit shared-memory read.
//  - B (K, N) is N-major, but mma's .col B operand wants 4 consecutive k
//    of one column in a register.  B lands as it is stored (16-byte copies
//    of 16 columns of one k row when N is a multiple of 16 and B starts on
//    16 bytes, byte loads otherwise); then the CTA transposes the stage
//    once into a K-major tile: a thread takes a 4 x 4 byte block, 4 word
//    reads, 8 byte permutes (prmt) and 4 word writes, two blocks a thread
//    a stage, one barrier more a stage.  The transposed words sit at word
//    (k / 4) ^ (n / 4 mod 16) of row n (pitch 80 bytes), so neither the
//    transpose's writes nor the fragment reads conflict on a bank, and a
//    B fragment register is one 32-bit read, as A's is.
//  - Rows past M, columns past N and k past K land as zeros.
//  - Split-K (``splits`` CTAs a tile, from the wrapper's plan when the
//    tiles alone would leave SMs idle): each split adds its exact int32
//    partial into an int32 workspace (red.global.add, order-free since
//    int32 addition wraps the same in any order), fences and takes a
//    ticket on the tile's counter; the last taker reads the sums, scales
//    them, writes the output and leaves the workspace and the counter at
//    0 for the next launch, so no launch needs a memset.
// The epilogue rounds the exact int32 sum to fp32 and multiplies by the row
// scale, then the column scale, in the plain version's order: bit-equal.
//
// Not yet done: wgmma (the transposed tile would take wgmma's swizzled
// layout), a 128-row tile at large M, and TMA.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int BK = 64;          // k a stage
constexpr int PITCH = BK + 16;  // A row pitch in bytes (conflict-free fragment reads)
constexpr int STAGES = 3;
constexpr int THREADS = 128;    // 4 warps

template <int BM, int BN>
struct Tiles {
  static constexpr int BPITCH = BN + 16;     // B row pitch in bytes
  int8_t a[STAGES][BM][PITCH];
  int8_t b[STAGES][BK][BPITCH];              // as stored: row k, column n
  int8_t bt[BN][PITCH];                      // transposed: row n, k swizzled
};

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The 4-byte word of k (k / 4 = w) in row n of the transposed tile: word
// w ^ (n / 4 mod 16), so that neither the transpose's stores nor the
// fragments' loads conflict on a bank.
__device__ __forceinline__ int bt_word(int n, int w) { return w ^ ((n >> 2) & 15); }

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int BM, int BN>
__global__ void __launch_bounds__(THREADS)
int8_mma(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
         const float* __restrict__ a_scale, const float* __restrict__ b_scale,
         float* __restrict__ out, int* __restrict__ ws, int* __restrict__ tickets,
         int M, int N, int K, int splits, int vec) {
  constexpr int WARPS_N = BM == 16 ? 4 : 2;
  constexpr int WM = BM / (4 / WARPS_N), WN = BN / WARPS_N;   // warp tile
  constexpr int MT = WM / 16, NT = WN / 8;
  __shared__ __align__(16) Tiles<BM, BN> s;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm0 = (warp / WARPS_N) * WM, wn0 = (warp % WARPS_N) * WN;
  const long long m0 = static_cast<long long>(blockIdx.y) * BM;
  const long long n0 = static_cast<long long>(blockIdx.x) * BN;
  const int ktiles = (K + BK - 1) / BK;
  const int per = (ktiles + splits - 1) / splits;
  const int kt0 = blockIdx.z * per;
  const int kt1 = min(ktiles, kt0 + per);
  const bool vec_a = vec & 1, vec_b = vec & 2;

  auto load = [&](int kt, int st) {
    const int k0 = kt * BK;
    if (vec_a) {
      for (int idx = tid; idx < BM * (BK / 16); idx += THREADS) {
        const int r = idx / (BK / 16), c = idx % (BK / 16);
        const long long m = m0 + r;
        const int k = k0 + 16 * c;
        const bool ok = m < M && k < K;
        dlk_cp_async16(reinterpret_cast<float*>(&s.a[st][r][16 * c]),
                       reinterpret_cast<const float*>(ok ? a + m * K + k : a), ok);
      }
    } else {
      for (int idx = tid; idx < BM * BK; idx += THREADS) {
        const int r = idx / BK, c = idx % BK;
        const long long m = m0 + r;
        const int k = k0 + c;
        s.a[st][r][c] = m < M && k < K ? a[m * K + k] : int8_t(0);
      }
    }
    if (vec_b) {
      for (int idx = tid; idx < BK * (BN / 16); idx += THREADS) {
        const int r = idx / (BN / 16), c = idx % (BN / 16);
        const long long k = k0 + r, n = n0 + 16 * c;
        const bool ok = k < K && n < N;
        dlk_cp_async16(reinterpret_cast<float*>(&s.b[st][r][16 * c]),
                       reinterpret_cast<const float*>(ok ? b + k * N + n : b), ok);
      }
    } else {
      for (int idx = tid; idx < BK * BN; idx += THREADS) {
        const int r = idx / BN, c = idx % BN;
        const long long k = k0 + r, n = n0 + c;
        s.b[st][r][c] = k < K && n < N ? b[k * N + n] : int8_t(0);
      }
    }
  };

  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (kt0 + st < kt1) load(kt0 + st, st);
    dlk_cp_async_commit();
  }
  for (int kt = kt0; kt < kt1; ++kt) {
    dlk_cp_async_wait<STAGES - 2>();
    __syncthreads();                     // stage kt landed; kt - 1 and bt consumed
    const int nk = kt + STAGES - 1;
    if (nk < kt1) load(nk, (nk - kt0) % STAGES);
    dlk_cp_async_commit();
    const int st = (kt - kt0) % STAGES;
    // B's 4 x 4 byte blocks transposed into bt by byte permutes: block
    // (k / 4, n / 4) = (kb, nb), 4 word reads, 8 permutes, 4 word writes
#pragma unroll
    for (int it = 0; it < BK * BN / 16 / THREADS; ++it) {
      const int blk = tid + it * THREADS, nb = blk % (BN / 4), kb = blk / (BN / 4);
      uint32_t w[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) w[q] = ld32(&s.b[st][4 * kb + q][4 * nb]);
      const uint32_t t0 = __byte_perm(w[0], w[1], 0x5140), t1 = __byte_perm(w[0], w[1], 0x7362);
      const uint32_t t2 = __byte_perm(w[2], w[3], 0x5140), t3 = __byte_perm(w[2], w[3], 0x7362);
      const uint32_t col[4] = {__byte_perm(t0, t2, 0x5410), __byte_perm(t0, t2, 0x7632),
                               __byte_perm(t1, t3, 0x5410), __byte_perm(t1, t3, 0x7632)};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int n = 4 * nb + c;
        *reinterpret_cast<uint32_t*>(&s.bt[n][4 * bt_word(n, kb)]) = col[c];
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t af[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int8_t* pa = &s.a[st][wm0 + 16 * i + g][kk + 4 * t];
        af[i][0] = ld32(pa);
        af[i][1] = ld32(pa + 8 * PITCH);
        af[i][2] = ld32(pa + 16);
        af[i][3] = ld32(pa + 8 * PITCH + 16);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = wn0 + 8 * j + g, w0 = kk / 4 + t;
        const uint32_t b0 = ld32(&s.bt[n][4 * bt_word(n, w0)]);
        const uint32_t b1 = ld32(&s.bt[n][4 * bt_word(n, w0 + 4)]);
#pragma unroll
        for (int i = 0; i < MT; ++i) mma_s8(acc[i][j], af[i], b0, b1);
      }
    }
  }
  dlk_cp_async_wait<0>();

  // c[0], c[1]: row g, columns 2t, 2t+1; c[2], c[3]: row g + 8
  auto each = [&](auto&& fn) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const long long m = m0 + wm0 + 16 * i + g + 8 * (e >> 1);
          const long long n = n0 + wn0 + 8 * j + 2 * t + (e & 1);
          if (m < M && n < N) fn(acc[i][j][e], m, n);
        }
  };
  auto scaled = [&](int x, long long m, long long n) {
    out[m * N + n] = __fmul_rn(__fmul_rn(__int2float_rn(x), a_scale[m]), b_scale[n]);
  };
  if (splits == 1) {
    each([&](int x, long long m, long long n) { scaled(x, m, n); });
    return;
  }
  each([&](int x, long long m, long long n) { atomicAdd(ws + m * N + n, x); });
  __shared__ int last;
  __threadfence();
  __syncthreads();
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  if (tid == 0) last = atomicAdd(tickets + tile, 1) == splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  each([&](int, long long m, long long n) {
    const int x = __ldcg(ws + m * N + n);
    ws[m * N + n] = 0;
    scaled(x, m, n);
  });
  if (tid == 0) tickets[tile] = 0;
}

template <int BM, int BN>
int launch(const int8_t* a, const int8_t* b, const float* a_scale,
           const float* b_scale, float* out, int* ws, int* tickets, int M, int N,
           int K, int splits, int vec, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((N + BN - 1) / BN),
                  static_cast<unsigned>((M + BM - 1) / BM),
                  static_cast<unsigned>(splits));
  int8_mma<BM, BN><<<grid, THREADS, 0, stream>>>(a, b, a_scale, b_scale, out, ws,
                                                 tickets, M, N, K, splits, vec);
  return dlk_last_error();
}

}  // namespace

// out (M, N) fp32 = float(a (M, K) int8 @ b (K, N) int8, summed in int32)
// * a_scale[m] * b_scale[n]; a, b and out row-major and contiguous.
// tile: 0 for 16 x 64 tiles, 1 for 64 x 64.  splits > 1 needs ws (M * N
// int32) and tickets (one int32 a tile), both all 0, and leaves them so.
// vec: bit 0 when A takes 16-byte copies (K % 16 == 0, aligned base), bit 1
// when B does (N % 16 == 0, aligned base).
extern "C" int dlk_int8_matmul(const int8_t* a, const int8_t* b,
                               const float* a_scale, const float* b_scale,
                               float* out, int* ws, int* tickets, int M, int N,
                               int K, int tile, int splits, int vec,
                               cudaStream_t stream) {
  if (M < 1 || N < 1 || K < 0 || splits < 1 || (splits > 1 && (!ws || !tickets)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (tile == 0)
    return launch<16, 64>(a, b, a_scale, b_scale, out, ws, tickets, M, N, K,
                          splits, vec, stream);
  if (tile == 1)
    return launch<64, 64>(a, b, a_scale, b_scale, out, ws, tickets, M, N, K,
                          splits, vec, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
