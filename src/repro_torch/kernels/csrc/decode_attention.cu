// B6 + B7: ragged flash-decode, one query token per lane against a ring or
// a paged KV cache, with fp32, bf16 or int8-with-scales K/V.
//
// Replaces repro/kernels/decode_attention.py::decode_attention (B6, the
// ring cache, body _decode_kernel) and ::decode_attention_paged (B7, the
// page-table twin, _paged_kernel).  On the TPU the grid walks the sequence
// in order and carries (m, l, acc) in VMEM scratch from block to block; the
// index maps clamp the block index to the lane's last useful block so that
// the pipeline skips the copies past the prefix, and the paged index map
// looks the physical page up in the table.
//
// Bound on the H100: the bytes of K/V (and scales) read for the valid
// prefix of every lane.  A decode step does 4*H*D flops per slot against
// 2*KV*D*elem bytes, about G flops per byte: far below the ~20 fp32 flops
// per byte at which the card stops being memory bound.
//
// Design: one CTA (128 threads) per (lane, KV head), so the G query heads
// of that KV head share every K/V tile; q sits in shared memory.  The CTA
// walks slots [0, valid_len[b]) in tiles of up to 64 slots, loads each K
// and V tile once, coalesced along head_dim, converts it to fp32 in shared
// memory (each thread keeps 8 loads of K and 8 of V in flight), and
// never touches a slot past the lane's prefix: the loop bound
// ceil(valid/T) replaces the TPU's clamp and pl.when.  Slot t of a paged
// lane is read from pool page page_table[b, t / ps] at offset t % ps, so a
// tile may span pages and the table is the gather.  Scores are one thread
// per (head, slot); then one warp per query head keeps the online softmax
// state (m, l, acc[D]) in fp32, reducing with warp shuffles.  int8 K/V are
// dequantized in the TPU kernel's order: the score column times k_scale
// after q.k*scale, and the probability times v_scale after l is updated.
// Both layouts (bksd and bskd) and layer views of (L, ...) caches are read
// by element strides, with head_dim contiguous.
//
// Not yet done (a later PR): split-KV with a combine pass (at batch 8 a
// TinyLlama step launches 32 CTAs for 132 SMs), 16-byte vector loads and
// TMA staging of the tiles.
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 8;             // tile elements each thread loads at once
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;
constexpr size_t SMEM_DEFAULT = 48 * 1024;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

// Where slot t of lane b lives.  Ring: outer index b, slot t.  Paged: outer
// index page_table[b, t / ps] (a pool page), slot t % ps.
struct Addr {
  long long s_outer, s_head, s_slot;   // payload element strides
  long long c_outer, c_head, c_slot;   // scale element strides (int8 only)
  const int* page_table;               // (B, W) int32; null for the ring
  int W, ps;                           // paged: table width, page size
  int n_outer;                         // lanes (ring) or pool pages (paged)
  int capacity;                        // S (ring) or W * ps (paged)
};

template <bool PAGED>
__device__ __forceinline__ bool locate(const Addr& a, int b, int t,
                                       long long& outer, int& slot) {
  if (PAGED) {
    outer = a.page_table[static_cast<long long>(b) * a.W + t / a.ps];
    slot = t % a.ps;
    return outer >= 0 && outer < a.n_outer;   // a bad table entry reads NaN
  }
  outer = b;
  slot = t;
  return true;
}

template <typename T, bool SCALED, bool PAGED>
__global__ void __launch_bounds__(THREADS)
decode_attn(const float* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const float* __restrict__ ks,
            const float* __restrict__ vs, const int* __restrict__ valid_len,
            float* __restrict__ out, int KV, int G, int D, int TS,
            float scale, Addr a) {
  extern __shared__ float smem[];
  const int b = blockIdx.x / KV, kvh = blockIdx.x % KV;
  const int DP = D + 1;                 // padded K rows: conflict-free dots
  float* q_s = smem;                    // G * D
  float* acc_s = q_s + G * D;           // G * D
  float* k_s = acc_s + G * D;           // TS * (D + 1)
  float* v_s = k_s + TS * DP;           // TS * D
  float* p_s = v_s + TS * D;            // G * TS
  float* m_s = p_s + G * TS;            // G
  float* l_s = m_s + G;                 // G
  float* ksc = l_s + G;                 // TS
  float* vsc = ksc + TS;                // TS
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long head0 = (static_cast<long long>(b) * KV + kvh) * G;
  const float* qb = q + head0 * D;
  float* ob = out + head0 * D;

  int valid = valid_len[b];
  if (valid < 1) {   // outside the contract (valid_len >= 1): poison the lane
    for (int i = tid; i < G * D; i += THREADS) ob[i] = nanf("");
    return;
  }
  valid = min(valid, a.capacity);
  for (int i = tid; i < G * D; i += THREADS) {
    q_s[i] = qb[i];
    acc_s[i] = 0.0f;
  }
  for (int g = tid; g < G; g += THREADS) {
    m_s[g] = NEG_INF;
    l_s[g] = 0.0f;
  }

  for (int t0 = 0; t0 < valid; t0 += TS) {
    const int n = min(TS, valid - t0);  // slots of this tile in the prefix
    __syncthreads();                    // the previous tile is consumed
    // UNROLL loads of K and of V in flight per thread before any store:
    // one load at a time would wait out the memory latency per element
    for (int base = 0; base < TS * D; base += THREADS * UNROLL) {
      float kx[UNROLL], vx[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int i = base + u * THREADS + tid;
        const int s = i / D, d = i - s * D;
        kx[u] = vx[u] = 0.0f;
        long long outer;
        int slot;
        if (i < TS * D && s < n) {
          if (locate<PAGED>(a, b, t0 + s, outer, slot)) {
            const long long off = outer * a.s_outer + kvh * a.s_head +
                                  slot * a.s_slot + d;
            kx[u] = to_f32(k[off]);
            vx[u] = to_f32(v[off]);
          } else {
            kx[u] = vx[u] = nanf("");
          }
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int i = base + u * THREADS + tid;
        const int s = i / D, d = i - s * D;
        if (i < TS * D) {
          k_s[s * DP + d] = kx[u];
          v_s[s * D + d] = vx[u];
        }
      }
    }
    if (SCALED) {
      for (int s = tid; s < TS; s += THREADS) {
        float kf = 0.0f, vf = 0.0f;
        long long outer;
        int slot;
        if (s < n && locate<PAGED>(a, b, t0 + s, outer, slot)) {
          const long long off = outer * a.c_outer + kvh * a.c_head +
                                slot * a.c_slot;
          kf = ks[off];
          vf = vs[off];
        }
        ksc[s] = kf;
        vsc[s] = vf;
      }
    }
    __syncthreads();
    // scores (G, TS): one thread per (head, slot); masked past the prefix
    for (int i = tid; i < G * TS; i += THREADS) {
      const int g = i / TS, s = i - g * TS;
      float sc = NEG_INF;
      if (s < n) {
        const float* qg = q_s + g * D;
        const float* kr = k_s + s * DP;
        float dot = 0.0f;
        for (int d = 0; d < D; ++d) dot = fmaf(qg[d], kr[d], dot);
        sc = dot * scale;
        if (SCALED) sc *= ksc[s];
      }
      p_s[i] = sc;
    }
    __syncthreads();
    // online softmax and the PV product, one warp per query head
    for (int g = warp; g < G; g += WARPS) {
      float* prow = p_s + g * TS;
      float mx = NEG_INF;
      for (int s = lane; s < TS; s += 32) mx = fmaxf(mx, prow[s]);
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.0f;
      for (int s = lane; s < TS; s += 32) {
        const float p = expf(prow[s] - m_new);
        sum += p;                       // l takes p before the V scale
        prow[s] = SCALED ? p * vsc[s] : p;
      }
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(FULL, sum, o);
      const float corr = expf(m_prev - m_new);
      __syncwarp();
      for (int d = lane; d < D; d += 32) {
        float pv = 0.0f;
        for (int s = 0; s < n; ++s) pv = fmaf(prow[s], v_s[s * D + d], pv);
        acc_s[g * D + d] = acc_s[g * D + d] * corr + pv;
      }
      __syncwarp();
      if (lane == 0) {
        m_s[g] = m_new;
        l_s[g] = l_s[g] * corr + sum;
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += THREADS) {
    ob[i] = acc_s[i] / fmaxf(l_s[i / D], 1e-30f);
  }
}

size_t smem_bytes(int G, int D, int TS) {
  return sizeof(float) *
         static_cast<size_t>(2 * G * D + TS * (D + 1) + TS * D + G * TS +
                             2 * G + 2 * TS);
}

template <typename T, bool SCALED, bool PAGED>
int launch(const float* q, const void* k, const void* v, const float* ks,
           const float* vs, const int* valid, float* out, int B, int KV,
           int G, int D, const Addr& a, cudaStream_t stream) {
  int TS = 64;                          // slots per tile
  while (TS > 8 && smem_bytes(G, D, TS) > SMEM_DEFAULT) TS /= 2;
  const size_t smem = smem_bytes(G, D, TS);
  auto kern = decode_attn<T, SCALED, PAGED>;
  if (smem > SMEM_DEFAULT) {
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  kern<<<static_cast<unsigned>(B) * KV, THREADS, smem, stream>>>(
      q, static_cast<const T*>(k), static_cast<const T*>(v), ks, vs, valid,
      out, KV, G, D, TS, scale, a);
  return dlk_last_error();
}

Addr ring_addr(int B, int S, long long s_outer, long long s_head,
               long long s_slot) {
  Addr a{};
  a.s_outer = s_outer;
  a.s_head = s_head;
  a.s_slot = s_slot;
  a.n_outer = B;
  a.capacity = S;
  return a;
}

Addr paged_addr(const int* pt, int W, int ps, int P, long long s_outer,
                long long s_head, long long s_slot) {
  Addr a{};
  a.s_outer = s_outer;
  a.s_head = s_head;
  a.s_slot = s_slot;
  a.page_table = pt;
  a.W = W;
  a.ps = ps;
  a.n_outer = P;
  a.capacity = W * ps;
  return a;
}

}  // namespace

// dtype codes of the float caches (the same numbers as CACHE_DTYPES in
// repro_torch/kernels/decode_attention.py)
enum DlkCacheDtype : int { DLK_F32 = 0, DLK_BF16 = 1 };

// out (B, KV*G, D) fp32 = attention of q (B, KV*G, D) fp32 over slots
// [0, valid[b]) of the ring caches k, v (B lanes of S slots, KV heads).
extern "C" int dlk_decode_attention(
    const float* q, const void* k, const void* v, const int* valid, float* out,
    int B, int KV, int G, int D, int S, int dtype, long long s_outer,
    long long s_head, long long s_slot, cudaStream_t stream) {
  const Addr a = ring_addr(B, S, s_outer, s_head, s_slot);
  if (dtype == DLK_BF16) {
    return launch<__nv_bfloat16, false, false>(q, k, v, nullptr, nullptr,
                                               valid, out, B, KV, G, D, a,
                                               stream);
  }
  return launch<float, false, false>(q, k, v, nullptr, nullptr, valid, out, B,
                                     KV, G, D, a, stream);
}

// The same over int8 ring caches with one fp32 scale per (lane, head, slot).
extern "C" int dlk_decode_attention_q8(
    const float* q, const void* k, const void* v, const float* ks,
    const float* vs, const int* valid, float* out, int B, int KV, int G, int D,
    int S, long long s_outer, long long s_head, long long s_slot,
    long long c_outer, long long c_head, long long c_slot,
    cudaStream_t stream) {
  Addr a = ring_addr(B, S, s_outer, s_head, s_slot);
  a.c_outer = c_outer;
  a.c_head = c_head;
  a.c_slot = c_slot;
  return launch<int8_t, true, false>(q, k, v, ks, vs, valid, out, B, KV, G, D,
                                     a, stream);
}

// The same over page pools (P pages of ps slots) through page_table (B, W).
extern "C" int dlk_decode_attention_paged(
    const float* q, const void* k, const void* v, const int* page_table,
    const int* valid, float* out, int B, int KV, int G, int D, int W, int ps,
    int P, int dtype, long long s_outer, long long s_head, long long s_slot,
    cudaStream_t stream) {
  const Addr a = paged_addr(page_table, W, ps, P, s_outer, s_head, s_slot);
  if (dtype == DLK_BF16) {
    return launch<__nv_bfloat16, false, true>(q, k, v, nullptr, nullptr,
                                              valid, out, B, KV, G, D, a,
                                              stream);
  }
  return launch<float, false, true>(q, k, v, nullptr, nullptr, valid, out, B,
                                    KV, G, D, a, stream);
}

// Paged int8 pools with their per-slot fp32 scale pools.
extern "C" int dlk_decode_attention_paged_q8(
    const float* q, const void* k, const void* v, const float* ks,
    const float* vs, const int* page_table, const int* valid, float* out,
    int B, int KV, int G, int D, int W, int ps, int P, long long s_outer,
    long long s_head, long long s_slot, long long c_outer, long long c_head,
    long long c_slot, cudaStream_t stream) {
  Addr a = paged_addr(page_table, W, ps, P, s_outer, s_head, s_slot);
  a.c_outer = c_outer;
  a.c_head = c_head;
  a.c_slot = c_slot;
  return launch<int8_t, true, true>(q, k, v, ks, vs, valid, out, B, KV, G, D,
                                    a, stream);
}
