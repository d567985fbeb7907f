// B2: fp32 convolution, NCHW input x OIHW weights + bias + activation, as
// one implicit-GEMM kernel.
//
// Replaces repro/kernels/conv2d.py::conv2d, which on the TPU is an XLA
// im2col (the (B*OH*OW, C*K*K) patch matrix written to HBM) feeding the
// Pallas MXU matmul (B1), whose output is then transposed back to NCHW.
// Here no patch matrix and no transposed output exist in device memory.
//
// Bound on the H100: without tensor cores the fp32 FFMA peak is 67 TFLOP/s.
// NIN's convs at batch 8 do 2*O*P*C*K*K flops against x, w and out read or
// written once: the 5x5 96->192 conv (P = 8 x 16 x 16 pixels, depth 2400)
// needs 28 us of FLOPs and 1.3 us of bytes, so operations bound every conv
// but the last 1x1 (192->10), which the bytes bound.
//
// Design:
//  - GEMM view: rows are the output channels O, columns the output pixels
//    (b, oh, ow), the depth is (c, kh, kw) in the JAX column order, so w is
//    read as the contiguous (O, C*K*K) matrix it is;
//  - a 256-thread CTA owns a 64 (O) x 128 (pixel) output tile; thread
//    (ty, tx) of a 16 x 16 grid accumulates 4 channels (4 ty + i) by 8
//    pixels (4 tx + e and 64 + 4 tx + e) in fp32 registers with FFMA, from
//    one float4 of the weight slab and two of the patch slab per depth
//    step;
//  - the depth is walked in slabs of 16 through a ring of 4 shared-memory
//    stages filled by cp.async (commit_group / wait_group), one
//    __syncthreads per slab; the weight slab is stored depth-major;
//  - the patch slab is gathered as it is loaded: each thread owns one
//    pixel of the tile (its input row and column origin and its image
//    offset computed once) and reads depth entries from a table built once
//    per CTA in shared memory (the input offset c*H*W + kh*W + kw and
//    (kh, kw) of every depth index of the CTA's range), so the loop does
//    no integer division; taps outside the image are zero-filled by
//    cp.async with source size 0;
//  - a 1x1 stride-1 unpadded conv over planes of a multiple of 4 pixels
//    (NIN's 32^2, 16^2, 8^2) needs no table: 16-byte cp.async of 4
//    contiguous pixels of one channel;
//  - the epilogue adds the bias and applies dlk_act (common.cuh) before the
//    one store, straight into NCHW, float4 along the pixels;
//  - when the tiles alone cannot fill the card (the 5x5 and 3x3 convs at
//    batch 8: 48 and 12 tiles for 132 SMs), the depth is split S ways
//    (S from the shape and the SM count, in the wrapper): each CTA writes
//    its partial tile to a workspace and a second pass sums the S tiles in
//    split order and runs the epilogue.  No float atomics: two runs are
//    bit-equal.
//
// Not yet done (a later PR): 3xTF32 mma.sync, which keeps fp32 accuracy
// on the tensor cores.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int BM = 64;               // output channels per tile
constexpr int BN = 128;              // output pixels per tile
constexpr int BK = 16;               // depth per slab
constexpr int STAGES = 4;
constexpr int THREADS = 256;
constexpr int AS = BM + 4;           // row stride of the depth-major weight slab
constexpr int BS = BN + 4;           // row stride of the patch slab
constexpr int MAX_SPLITS = 8;
constexpr size_t PIPE_BYTES = sizeof(float) * STAGES * BK * (AS + BS);
constexpr size_t SMEM_MAX = 232448;  // 227 KB

struct Conv {
  int B, C, H, W, O, KS, stride, pad, OH, OW;
  int K;          // depth C * KS * KS
  int P;          // output pixels B * OH * OW
  int OHW;
  int act;
  int span;       // depth per split, a multiple of BK
};

// act(v + bias) for 4 pixels of channel o starting at pixel p (p a multiple
// of 4), stored into NCHW; float4 when a plane holds a multiple of 4 pixels.
__device__ __forceinline__ void store4(float* __restrict__ out, const Conv& cv,
                                       int o, int p, float4 v, float bias) {
  float x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) x[e] = dlk_act(x[e] + bias, cv.act);
  if (cv.OHW % 4 == 0) {
    if (p >= cv.P) return;
    const int b = p / cv.OHW, hw = p - b * cv.OHW;
    float* dst = out + (static_cast<long long>(b) * cv.O + o) * cv.OHW + hw;
    *reinterpret_cast<float4*>(dst) = make_float4(x[0], x[1], x[2], x[3]);
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int q = p + e;
    if (q >= cv.P) return;
    const int b = q / cv.OHW, hw = q - b * cv.OHW;
    out[(static_cast<long long>(b) * cv.O + o) * cv.OHW + hw] = x[e];
  }
}

// One CTA: the (o0, p0) tile over depth [kbeg, kend) of split blockIdx.z,
// stored through the epilogue (SPLIT false) or as a partial tile into ws.
// VEC: the 1x1 stride-1 path with 16-byte patch loads.
template <bool VEC, bool SPLIT>
__global__ void __launch_bounds__(THREADS)
conv_igemm(const float* __restrict__ x, const float* __restrict__ w,
           const float* __restrict__ bias, float* __restrict__ out,
           float* __restrict__ ws, Conv cv) {
  extern __shared__ float4 smem4[];
  float* a_s = reinterpret_cast<float*>(smem4);         // STAGES x BK x AS
  float* b_s = a_s + STAGES * BK * AS;                  // STAGES x BK x BS
  int2* ktab = reinterpret_cast<int2*>(b_s + STAGES * BK * BS);
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int p0 = blockIdx.x * BN, o0 = blockIdx.y * BM;
  const int kbeg = blockIdx.z * cv.span;
  const int kend = min(cv.K, kbeg + cv.span);
  const int nslab = kend > kbeg ? (kend - kbeg + BK - 1) / BK : 0;
  const long long chw = static_cast<long long>(cv.H) * cv.W;

  // the patch loads: this thread's pixel (or group of 4) and depth rows
  long long pix_off = 0;
  int ih0 = 0, iw0 = 0;
  bool pix_ok;
  if constexpr (VEC) {
    const int p = p0 + 4 * (tid % 32);                 // rows kk = tid / 32 + 8 r
    pix_ok = p < cv.P;
    const int b = pix_ok ? p / cv.OHW : 0;
    pix_off = static_cast<long long>(b) * cv.C * chw + (p - b * cv.OHW);
  } else {
    const int p = p0 + tid % BN;                       // rows kk = tid / BN + 2 r
    pix_ok = p < cv.P;
    const int b = pix_ok ? p / cv.OHW : 0;
    const int hw = pix_ok ? p - b * cv.OHW : 0;
    const int oh = hw / cv.OW, ow = hw - (hw / cv.OW) * cv.OW;
    ih0 = oh * cv.stride - cv.pad;
    iw0 = ow * cv.stride - cv.pad;
    pix_off = static_cast<long long>(b) * cv.C * chw +
              static_cast<long long>(ih0) * cv.W + iw0;
    const int kk2 = cv.KS * cv.KS;
    for (int i = tid; i < kend - kbeg; i += THREADS) {
      const int k = kbeg + i;
      const int c = k / kk2, r = k - c * kk2;
      const int kh = r / cv.KS, kw = r - kh * cv.KS;
      ktab[i] = make_int2(static_cast<int>(c * chw) + kh * cv.W + kw,
                          (kh << 16) | kw);
    }
    __syncthreads();
  }

  auto load_slab = [&](int stage, int slab) {
    const int k0 = kbeg + slab * BK;
    float* a_dst = a_s + stage * BK * AS;
    float* b_dst = b_s + stage * BK * BS;
    // weights: 64 x 16, consecutive threads along the depth
#pragma unroll
    for (int r = 0; r < (BM * BK) / THREADS; ++r) {
      const int idx = tid + r * THREADS;
      const int kk = idx % BK, oo = idx / BK;
      const int o = o0 + oo, k = k0 + kk;
      const bool ok = o < cv.O && k < kend;
      dlk_cp_async4(a_dst + kk * AS + oo,
                ok ? w + static_cast<long long>(o) * cv.K + k : w, ok);
    }
    if constexpr (VEC) {
      // 16 channels x 32 groups of 4 contiguous pixels
#pragma unroll
      for (int r = 0; r < (BK * BN / 4) / THREADS; ++r) {
        const int kk = tid / 32 + 8 * r, k = k0 + kk;
        const bool ok = pix_ok && k < kend;
        dlk_cp_async16(b_dst + kk * BS + 4 * (tid % 32),
                   ok ? x + pix_off + k * chw : x, ok);
      }
    } else {
#pragma unroll
      for (int r = 0; r < (BK * BN) / THREADS; ++r) {
        const int kk = tid / BN + 2 * r, k = k0 + kk;
        bool ok = pix_ok && k < kend;
        int2 e = make_int2(0, 0);
        if (ok) e = ktab[k - kbeg];
        const int ih = ih0 + (e.y >> 16), iw = iw0 + (e.y & 0xffff);
        ok = ok && static_cast<unsigned>(ih) < static_cast<unsigned>(cv.H) &&
             static_cast<unsigned>(iw) < static_cast<unsigned>(cv.W);
        dlk_cp_async4(b_dst + kk * BS + tid % BN, ok ? x + pix_off + e.x : x, ok);
      }
    }
  };

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nslab) load_slab(s, s);
    dlk_cp_async_commit();
  }
  for (int t = 0; t < nslab; ++t) {
    dlk_cp_async_wait<STAGES - 2>();     // slab t has landed (this thread's copies)
    __syncthreads();                 // everyone's; and slab t - 1 is consumed
    const int next = t + STAGES - 1;
    if (next < nslab) load_slab(next % STAGES, next);
    dlk_cp_async_commit();
    const float* a_t = a_s + (t % STAGES) * BK * AS;
    const float* b_t = b_s + (t % STAGES) * BK * BS;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(a_t + kk * AS + 4 * ty);
      const float4 b0 = *reinterpret_cast<const float4*>(b_t + kk * BS + 4 * tx);
      const float4 b1 =
          *reinterpret_cast<const float4*>(b_t + kk * BS + 64 + 4 * tx);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
  dlk_cp_async_wait<0>();

  if constexpr (!SPLIT) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int o = o0 + 4 * ty + i;
      if (o >= cv.O) continue;
      const float bo = bias ? bias[o] : 0.0f;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        store4(out, cv, o, p0 + 64 * h + 4 * tx,
               make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                           acc[i][4 * h + 3]),
               bo);
    }
  } else {
    // partial tile of split z into ws (S, O, P)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int o = o0 + 4 * ty + i;
      if (o >= cv.O) continue;
      float* row = ws + (static_cast<long long>(blockIdx.z) * cv.O + o) * cv.P;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int p = p0 + 64 * (j / 4) + 4 * tx + j % 4;
        if (p < cv.P) row[p] = acc[i][j];
      }
    }
  }
}

// The workspace's S partial tiles summed in split order, then the epilogue.
__global__ void __launch_bounds__(THREADS)
conv_reduce(const float* __restrict__ ws, const float* __restrict__ bias,
            float* __restrict__ out, Conv cv, int splits) {
  const long long n = static_cast<long long>(cv.O) * cv.P;
  const long long i = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (i >= n) return;
  const int o = static_cast<int>(i / cv.P), p = static_cast<int>(i % cv.P);
  float sum = ws[i];
  for (int s = 1; s < splits; ++s) sum += ws[s * n + i];
  if (bias) sum += bias[o];
  const int b = p / cv.OHW, hw = p - b * cv.OHW;
  out[(static_cast<long long>(b) * cv.O + o) * cv.OHW + hw] = dlk_act(sum, cv.act);
}

size_t smem_bytes(const Conv& cv, bool vec) {
  return PIPE_BYTES + (vec ? 0 : sizeof(int2) * static_cast<size_t>(cv.span));
}

template <bool VEC, bool SPLIT>
int launch(const float* x, const float* w, const float* bias, float* out,
           float* ws, const Conv& cv, int splits, cudaStream_t stream) {
  auto kern = conv_igemm<VEC, SPLIT>;
  static DlkSmemOnce once;
  if (int err = dlk_prepare_smem(kern, SMEM_MAX, once)) return err;
  const dim3 grid((cv.P + BN - 1) / BN, (cv.O + BM - 1) / BM, splits);
  kern<<<grid, THREADS, smem_bytes(cv, VEC), stream>>>(x, w, bias, out, ws, cv);
  if (int err = dlk_last_error()) return err;
  if constexpr (SPLIT) {
    const long long n = static_cast<long long>(cv.O) * cv.P;
    conv_reduce<<<static_cast<unsigned>((n + THREADS - 1) / THREADS), THREADS, 0,
                  stream>>>(ws, bias, out, cv, splits);
    return dlk_last_error();
  }
  return 0;
}

template <bool VEC>
int dispatch(const float* x, const float* w, const float* bias, float* out,
             float* ws, const Conv& cv, int splits, cudaStream_t stream) {
  if (splits == 1) return launch<VEC, false>(x, w, bias, out, ws, cv, 1, stream);
  return launch<VEC, true>(x, w, bias, out, ws, cv, splits, stream);
}

}  // namespace

// out (B, O, OH, OW) = act(conv2d(x (B, C, H, W), w (O, C, KS, KS)) + bias),
// all contiguous fp32 (bias (O,) or null), stride and zero padding `pad`;
// the depth split `splits` ways (1..8), the partial tiles summed through ws
// (splits x O x P floats; unused, and may be null, when splits is 1).
extern "C" int dlk_conv2d_f32(const float* x, const float* w, const float* bias,
                              float* out, float* ws, int B, int C, int H, int W,
                              int O, int KS, int stride, int pad, int act,
                              int splits, cudaStream_t stream) {
  Conv cv;
  cv.B = B;
  cv.C = C;
  cv.H = H;
  cv.W = W;
  cv.O = O;
  cv.KS = KS;
  cv.stride = stride;
  cv.pad = pad;
  cv.OH = (H + 2 * pad - KS) / stride + 1;
  cv.OW = (W + 2 * pad - KS) / stride + 1;
  cv.K = C * KS * KS;
  cv.P = B * cv.OH * cv.OW;
  cv.OHW = cv.OH * cv.OW;
  cv.act = act;
  const int slabs = (cv.K + BK - 1) / BK;
  if (splits < 1 || splits > MAX_SPLITS || (splits > 1 && ws == nullptr) ||
      cv.OH <= 0 || cv.OW <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cv.span = (slabs + splits - 1) / splits * BK;
  const bool vec = KS == 1 && stride == 1 && pad == 0 && (H * W) % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (smem_bytes(cv, vec) > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  return vec ? dispatch<true>(x, w, bias, out, ws, cv, splits, stream)
             : dispatch<false>(x, w, bias, out, ws, cv, splits, stream);
}
