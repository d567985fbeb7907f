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
// per byte at which the card stops being memory bound.  At the serving
// shapes (8 lanes of a few hundred slots) the bytes are under a megabyte,
// so the floor is the chain of dependent memory round trips of one CTA and
// the launch, not the bandwidth.
//
// Design (the FFMA route, decode_attn_split; the wide route below shares
// its grid and staging): split-KV.  The grid is (lane x KV head, split);
// split i owns the slots [i*C, (i+1)*C) of the lane's prefix, C (the
// chunk) fixed by the wrapper from the shapes
// (repro_torch/kernels/decode_attention.py::plan), never from valid_len,
// so a lane's output depends on its own K/V and valid_len alone.  A CTA
// whose chunk starts past the prefix exits at once.  The G query heads of
// the KV head share each K/V row, as in the TPU kernel.  A CTA of 128
// threads:
//  1. reads valid_len and, on the paged route, its chunk's page ids (one
//     table read a page, checked against the pool; an id outside the pool
//     reads as NaN) side by side;
//  2. copies q and the chunk's K and V rows (and the int8 scales) into
//     shared memory with cp.async, 16 bytes a copy where the strides and
//     the base allow (8 or 4 otherwise), every copy in flight at once, K
//     and V in two groups so that the scores start while V arrives; a
//     paged row's address is its page's offset plus stride arithmetic;
//  3. scores: one thread per (slot, group of heads), each K row read once
//     for all of the thread's heads, 16 bytes a shared-memory read, q.k in
//     four FFMA chains (one per vector lane) added pairwise; int8: times
//     k_scale after q.k*scale;
//  4. softmax within the chunk, one warp per head: m = max, p = e^(s-m),
//     l = sum p (before the V scale);
//  5. P.V: one thread per 4 output columns of a head, over the chunk's
//     slots in two chains (alternate slots), p times v_scale first; where
//     the outputs are fewer than the threads, the slots are dealt to
//     groups of threads whose sums are added in group order;
//  6. a lane whose prefix fits one chunk writes acc / max(l, 1e-30) at
//     once.  Otherwise each split writes its partial (m, l, acc) to a
//     workspace, and one thread fences and takes a ticket on the (lane, KV
//     head) counter (an atomic on the counter only); the CTA that draws
//     the last ticket merges the partials in split order (m = max m_i,
//     l = sum l_i e^(m_i - m), acc likewise), writes the output and resets
//     the counter to 0.  The tickets a lane expects, ceil(min(valid, capacity) / C),
//     come from valid_len on the device; empty splits take none.  So two
//     runs are bit-equal and the workspace needs no memset per call.
// fp32 FFMA throughout, no TF32.  valid_len is clamped to the capacity; a
// lane whose valid_len is below 1 gets NaN; no K/V byte past a lane's
// prefix is read.  Both layouts (bksd and bskd) and layer views of
// (L, ...) caches are read by element strides, with head_dim contiguous.
//
// The wide route (decode_attn_wide + decode_merge_wide), which the
// wrapper's plan() picks for G = 16 query heads on a KV head
// (RecurrentGemma's MQA, head_dim 256) and head dims a multiple of 32,
// chunks a multiple of 32 (plan() raises where the pages leave none).  At
// that shape the FFMA route is far from its byte bound: one 128-thread
// CTA works 16 heads x 256 dims of FFMA over a chunk that its shared-memory
// budget halves to 32 slots, and a lane's last CTA merges up to 64 splits
// x 4096 outputs alone.  Here:
//  - the 16 heads are exactly mma's M: q.k^T (16 x D . D x chunk) and p.V
//    (16 x chunk . chunk x D) run on mma.sync m16n8k8 in 3xTF32 (plain
//    TF32 breaks the fp32 bar), each operand split hi = rna(x), lo = x -
//    hi in registers as it is read from shared memory;
//  - the work is spread over the CTA's 4 warps by output columns: slots
//    for the scores, head dims for p.V;
//  - the tensor core truncates its running sums, so each product's small
//    terms go on an accumulator of their own and its hi.hi terms are spread
//    over 8 (scores) and 4 (p.V) accumulators, added in fp32 (with every
//    term of a k-step on one of 4 accumulators, the error against fp64 was
//    3x the FFMA route's);
//  - chunks of 64 slots (plan's WIDE_CHUNK; 128 took 1.4x as long at the
//    hybrid's live lanes), one CTA an SM; V's rows of fp32 are padded to
//    8 mod 32 words so that its B fragments read 32 banks;
//  - the splits are merged by a second kernel, a thread per 4 outputs of a
//    (lane, KV head), each summing that lane's splits in split order, so
//    no CTA reads every partial alone; there are no tickets or counters,
//    and two runs are bit-equal.
// The grid, the staging, the NaN lanes and the prefix-only reads are the
// FFMA route's.
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

// One call's geometry and launch plan, as the wrapper fills it
// (DecodePlan in repro_torch/kernels/decode_attention.py, field for field).
struct DlkDecodePlan {
  long long s_outer, s_head, s_slot;   // payload element strides
  long long c_outer, c_head, c_slot;   // scale element strides (int8 only)
  float* ws;        // counters (B*KV ints, padded to 4), partial acc, (m, l)
  int B, KV, G, D;
  int slots;        // S (ring) or page size ps (paged)
  int W;            // page-table width (paged)
  int n_outer;      // lanes (ring) or pool pages (paged)
  int dtype;        // DlkCacheDtype
  int chunk;        // slots a split: a multiple of ps, or a divisor of it
  int n_split;      // ceil(capacity / chunk)
  int vw;           // bytes a global -> shared copy: 16, 8 or 4
  int wide;         // 1: the wide-group route (G = 16 on mma.sync)
  float scale;      // 1 / sqrt(D)
};

// dtype codes of the caches (the same numbers as CACHE_DTYPES in
// repro_torch/kernels/decode_attention.py)
enum DlkCacheDtype : int { DLK_F32 = 0, DLK_BF16 = 1, DLK_I8 = 2 };

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_CHUNK = THREADS;    // one score thread per slot at least
constexpr int HB = 4;                 // heads a score thread takes per K row pass
constexpr int MIN_CTAS = 4;           // resident CTAs an SM: at most 128 registers
constexpr int MERGE = 8;              // partials a merging thread loads at once
constexpr size_t MAX_SMEM = 200 * 1024;   // opted into once; plans stay under it
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

// Shared-memory layout of one CTA, in bytes (host and device agree).
struct Smem {
  int row;                      // bytes a staged K/V row: an odd multiple of 16
  size_t k, v, p, m, l, ksc, vsc, red, total;
};

__host__ __device__ inline Smem smem_layout(int G, int D, int C, int elem,
                                            bool scaled) {
  Smem s;
  int r16 = (D * elem + 15) / 16;
  if (r16 % 2 == 0) ++r16;      // odd: 8 neighbouring rows, 8 distinct banks
  s.row = 16 * r16;
  s.k = sizeof(float) * static_cast<size_t>(G) * D;   // after q (G x D)
  s.v = s.k + static_cast<size_t>(C) * s.row;
  s.p = s.v + static_cast<size_t>(C) * s.row;         // G x (C + 1) floats
  s.m = s.p + sizeof(float) * static_cast<size_t>(G) * (C + 1);
  s.l = s.m + sizeof(float) * G;
  s.ksc = s.l + sizeof(float) * G;
  s.vsc = s.ksc + (scaled ? sizeof(float) * C : 0);
  s.red = (s.vsc + (scaled ? sizeof(float) * C : 0) + 15) / 16 * 16;
  s.total = s.red + 16 * THREADS;                     // slot-group partials
  return s;
}

__device__ __forceinline__ float4 f4(float x, float y, float z, float w) {
  return make_float4(x, y, z, w);
}

// bf16 -> fp32 is exact by bits: the high half, or the low half shifted up.
__device__ __forceinline__ float bf_lo(unsigned w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf_hi(unsigned w) { return __uint_as_float(w & 0xffff0000u); }
__device__ __forceinline__ float i8_at(unsigned w, int i) {
  return static_cast<float>(static_cast<int8_t>((w >> (8 * i)) & 0xffu));
}

// Four elements of a staged row (fp32 16 bytes, bf16 8, int8 4) as floats.
template <typename T> __device__ __forceinline__ float4 load4(const unsigned char* p);
template <> __device__ __forceinline__ float4 load4<float>(const unsigned char* p) {
  return *reinterpret_cast<const float4*>(p);
}
template <> __device__ __forceinline__ float4 load4<__nv_bfloat16>(const unsigned char* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return f4(bf_lo(u.x), bf_hi(u.x), bf_lo(u.y), bf_hi(u.y));
}
template <> __device__ __forceinline__ float4 load4<int8_t>(const unsigned char* p) {
  const unsigned w = *reinterpret_cast<const unsigned*>(p);
  return f4(i8_at(w, 0), i8_at(w, 1), i8_at(w, 2), i8_at(w, 3));
}

// 16 bytes of a staged row as 16 / sizeof(T) floats, one shared-memory read.
template <typename T> __device__ __forceinline__ void load16(const unsigned char* p, float* f);
template <> __device__ __forceinline__ void load16<float>(const unsigned char* p, float* f) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  f[0] = x.x;
  f[1] = x.y;
  f[2] = x.z;
  f[3] = x.w;
}
template <> __device__ __forceinline__ void load16<__nv_bfloat16>(const unsigned char* p,
                                                                  float* f) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = bf_lo(w[i]);
    f[2 * i + 1] = bf_hi(w[i]);
  }
}
template <> __device__ __forceinline__ void load16<int8_t>(const unsigned char* p, float* f) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) f[4 * i + j] = i8_at(w[i], j);
}

// q.k into four chains, one per vector lane (head_dim / 4 terms each).
__device__ __forceinline__ void fma4(float4& acc, float4 q, float4 k) {
  acc.x = fmaf(q.x, k.x, acc.x);
  acc.y = fmaf(q.y, k.y, acc.y);
  acc.z = fmaf(q.z, k.z, acc.z);
  acc.w = fmaf(q.w, k.w, acc.w);
}

// Global -> shared copy of vw bytes (16, 8 or 4; vw is uniform in a CTA).
__device__ __forceinline__ void copy_async(unsigned char* dst, const unsigned char* src,
                                           int vw) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (vw == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
  } else if (vw == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
  }
}

// All-ones bytes: NaN for fp32 and bf16 (int8 rows get NaN scales instead).
__device__ __forceinline__ void fill_nan(unsigned char* dst, int vw) {
  if (vw == 16) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(~0u, ~0u, ~0u, ~0u);
  } else if (vw == 8) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(~0u, ~0u);
  } else {
    *reinterpret_cast<unsigned*>(dst) = ~0u;
  }
}

template <typename T, bool SCALED, bool PAGED>
__global__ void __launch_bounds__(THREADS, MIN_CTAS)
decode_attn_split(const float* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const float* __restrict__ ks,
                  const float* __restrict__ vs, const int* __restrict__ page_table,
                  const int* __restrict__ valid_len, float* __restrict__ out,
                  const DlkDecodePlan pl) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ long long page_off[MAX_CHUNK], cpage_off[MAX_CHUNK];
  __shared__ int s_last;
  const int G = pl.G, D = pl.D, C = pl.chunk, ps = pl.slots;
  const int bk = blockIdx.x, split = blockIdx.y;
  const int b = bk / pl.KV, kvh = bk - b * pl.KV;
  const int tid = threadIdx.x;
  const int t0 = split * C;
  float* ob = out + static_cast<long long>(bk) * G * D;

  // the chunk's page ids, read beside valid_len: one table read a page
  // (ids past the prefix are read and never used; no K/V byte is)
  const int npages = PAGED ? (C >= ps ? C / ps : 1) : 0;
  const int page0 = PAGED ? t0 / ps : 0;
  int pid = -1;
  if (PAGED && tid < npages && page0 + tid < pl.W)
    pid = page_table[static_cast<long long>(b) * pl.W + page0 + tid];
  int valid = valid_len[b];
  if (valid < 1) {   // outside the contract (valid_len >= 1): poison the lane
    if (split == 0)
      for (int i = tid; i < G * D; i += THREADS) ob[i] = nanf("");
    return;
  }
  valid = min(valid, PAGED ? pl.W * ps : pl.slots);
  if (t0 >= valid) return;                 // an empty split: no ticket
  const int n = min(C, valid - t0);        // slots of this chunk in the prefix
  const int expected = (valid + C - 1) / C;

  const Smem lay = smem_layout(G, D, C, sizeof(T), SCALED);
  float* q_s = reinterpret_cast<float*>(smem);
  unsigned char* k_s = smem + lay.k;
  unsigned char* v_s = smem + lay.v;
  float* p_s = reinterpret_cast<float*>(smem + lay.p);
  float* m_s = reinterpret_cast<float*>(smem + lay.m);
  float* l_s = reinterpret_cast<float*>(smem + lay.l);
  float* ksc = reinterpret_cast<float*>(smem + lay.ksc);
  float* vsc = reinterpret_cast<float*>(smem + lay.vsc);
  float4* red = reinterpret_cast<float4*>(smem + lay.red);
  const int PS = C + 1;                    // score row stride (floats)

  // q: G x D floats, 16-byte aligned (the wrapper sees to it)
  const float* qb = q + static_cast<long long>(bk) * G * D;
  for (int i = tid; i < G * D / 4; i += THREADS)
    dlk_cp_async16(q_s + 4 * i, qb + 4 * i, true);
  if (PAGED) {
    if (tid < npages) {
      const bool ok = pid >= 0 && pid < pl.n_outer;
      page_off[tid] = ok ? pid * pl.s_outer + kvh * pl.s_head : -1;
      cpage_off[tid] = ok ? pid * pl.c_outer + kvh * pl.c_head : -1;
    }
    __syncthreads();
  }

  // K rows (and k_scale), then V rows (and v_scale), of the chunk's prefix
  // slots: two cp.async groups, every copy in flight, the scores computed
  // while V still arrives
  const int vw = pl.vw;
  const int row_vecs = D * static_cast<int>(sizeof(T)) / vw;
  const int lanes = min(row_vecs, THREADS);
  const int rows_per_pass = THREADS / lanes;
  const int vl = tid % lanes, r0 = tid / lanes;
  const int in_page0 = PAGED && C < ps ? t0 % ps : 0;
  auto stage = [&](const T* src, const float* sc, unsigned char* dst, float* sc_dst) {
    for (int s = r0; s < n && r0 < rows_per_pass; s += rows_per_pass) {
      long long off, coff;
      bool ok = true;
      if (PAGED) {
        const int j = C >= ps ? s / ps : 0;
        const int o = C >= ps ? s - j * ps : in_page0 + s;
        ok = page_off[j] >= 0;
        off = page_off[j] + o * pl.s_slot;
        coff = cpage_off[j] + o * pl.c_slot;
      } else {
        off = b * pl.s_outer + kvh * pl.s_head + (t0 + s) * pl.s_slot;
        coff = b * pl.c_outer + kvh * pl.c_head + (t0 + s) * pl.c_slot;
      }
      unsigned char* d = dst + s * lay.row;
      if (ok) {
        const unsigned char* g = reinterpret_cast<const unsigned char*>(src + off);
        for (int e = vl; e < row_vecs; e += lanes) copy_async(d + e * vw, g + e * vw, vw);
        if (SCALED && vl == 0) dlk_cp_async4(sc_dst + s, sc + coff, true);
      } else {                             // a page id outside the pool
        for (int e = vl; e < row_vecs; e += lanes) fill_nan(d + e * vw, vw);
        if (SCALED && vl == 0) sc_dst[s] = nanf("");
      }
    }
    dlk_cp_async_commit();
  };
  stage(k, ks, k_s, ksc);
  stage(v, vs, v_s, vsc);
  dlk_cp_async_wait<1>();                  // q and K have landed
  __syncthreads();

  // scores (G, n): thread (slot s, head group hg) owns heads hg, hg + HG, ...
  {
    constexpr int N16 = 16 / static_cast<int>(sizeof(T));   // elements a read
    const int HG = THREADS / C;
    const int s = tid % C, hg = tid / C;
    if (s < n && hg < HG) {
      const unsigned char* kr = k_s + s * lay.row;
      const float4* q4 = reinterpret_cast<const float4*>(q_s);
      for (int i0 = 0; hg + HG * i0 < G; i0 += HB) {
        int gh[HB];
        float4 dot[HB];
#pragma unroll
        for (int h = 0; h < HB; ++h) {
          gh[h] = hg + HG * (i0 + h);
          dot[h] = f4(0.0f, 0.0f, 0.0f, 0.0f);
        }
        int d = 0;
#pragma unroll 4
        for (; d + N16 <= D; d += N16) {
          float kf[N16];
          load16<T>(kr + d * sizeof(T), kf);
#pragma unroll
          for (int h = 0; h < HB; ++h) {
            if (gh[h] < G) {
              const float4* qg = q4 + (gh[h] * D + d) / 4;
#pragma unroll
              for (int u = 0; u < N16 / 4; ++u)
                fma4(dot[h], qg[u], f4(kf[4 * u], kf[4 * u + 1], kf[4 * u + 2],
                                       kf[4 * u + 3]));
            }
          }
        }
        for (; d < D; d += 4) {            // head_dim not a multiple of N16
          const float4 kf = load4<T>(kr + d * sizeof(T));
#pragma unroll
          for (int h = 0; h < HB; ++h)
            if (gh[h] < G) fma4(dot[h], q4[(gh[h] * D + d) / 4], kf);
        }
#pragma unroll
        for (int h = 0; h < HB; ++h) {
          if (gh[h] < G) {
            float sc = ((dot[h].x + dot[h].y) + (dot[h].z + dot[h].w)) * pl.scale;
            if (SCALED) sc *= ksc[s];
            p_s[gh[h] * PS + s] = sc;
          }
        }
      }
    }
  }
  __syncthreads();

  // softmax within the chunk, one warp per head
  const int warp = tid / 32, lane = tid % 32;
  for (int g = warp; g < G; g += WARPS) {
    float* row = p_s + g * PS;
    float mx = NEG_INF;
    for (int s = lane; s < n; s += 32) mx = fmaxf(mx, row[s]);
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
    float sum = 0.0f;
    for (int s = lane; s < n; s += 32) {
      const float p = expf(row[s] - mx);
      sum += p;                            // l takes p before the V scale
      row[s] = p;
    }
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(FULL, sum, o);
    if (lane == 0) {
      m_s[g] = mx;
      l_s[g] = sum;
    }
  }
  dlk_cp_async_wait<0>();                  // V has landed
  __syncthreads();

  // P.V: thread (slot group sg, output o = (head, 4 columns))
  const int D4 = D / 4, O = G * D4;
  const int NSG = O >= THREADS ? 1 : THREADS / O;
  const bool multi = expected > 1;
  float* acc_ws = pl.ws + (pl.B * pl.KV + 3) / 4 * 4;
  float* ml_ws = acc_ws + static_cast<long long>(pl.B) * pl.KV * pl.n_split * G * D;
  const long long part = static_cast<long long>(bk) * pl.n_split + split;
  auto pv = [&](int o, int sg) {           // two chains: alternate slots
    const int g = o / D4, c = o - g * D4;
    const float* prow = p_s + g * PS;
    const unsigned char* vcol = v_s + 4 * c * sizeof(T);
    auto add = [&](float4& y, int s) {
      const float p = SCALED ? prow[s] * vsc[s] : prow[s];   // p x v_scale
      const float4 x = load4<T>(vcol + s * lay.row);
      y.x = fmaf(p, x.x, y.x);
      y.y = fmaf(p, x.y, y.y);
      y.z = fmaf(p, x.z, y.z);
      y.w = fmaf(p, x.w, y.w);
    };
    float4 a0 = f4(0.0f, 0.0f, 0.0f, 0.0f), a1 = a0;
    int s = sg;
#pragma unroll 2
    for (; s + NSG < n; s += 2 * NSG) {
      add(a0, s);
      add(a1, s + NSG);
    }
    if (s < n) add(a0, s);
    return f4(a0.x + a1.x, a0.y + a1.y, a0.z + a1.z, a0.w + a1.w);
  };
  auto put = [&](int o, float4 a) {        // the output, or this split's part
    if (multi) {
      reinterpret_cast<float4*>(acc_ws + part * G * D)[o] = a;
    } else {
      const float inv = 1.0f / fmaxf(l_s[o / D4], 1e-30f);
      reinterpret_cast<float4*>(ob)[o] = f4(a.x * inv, a.y * inv, a.z * inv, a.w * inv);
    }
  };
  if (NSG == 1) {
    for (int o = tid; o < O; o += THREADS) put(o, pv(o, 0));
  } else {                                 // groups' sums added in group order
    const int o = tid % O, sg = tid / O;
    red[tid] = sg < NSG ? pv(o, sg) : f4(0.0f, 0.0f, 0.0f, 0.0f);
    __syncthreads();
    if (sg == 0) {
      float4 a = red[tid];
      for (int i = 1; i < NSG; ++i) {
        const float4 x = red[i * O + o];
        a.x += x.x;
        a.y += x.y;
        a.z += x.z;
        a.w += x.w;
      }
      put(o, a);
    }
  }
  if (!multi) return;

  // the partial (m, l); then, after the CTA's barrier, one thread fences
  // (publishing every thread's writes: the fence is cumulative) and takes
  // a ticket on the lane's counter; the last taker fences again before the
  // CTA reads the other splits' partials
  if (tid < G) {
    ml_ws[part * 2 * G + tid] = m_s[tid];
    ml_ws[part * 2 * G + G + tid] = l_s[tid];
  }
  __syncthreads();
  int* counter = reinterpret_cast<int*>(pl.ws) + bk;
  if (tid == 0) {
    __threadfence();
    const bool last = atomicAdd(counter, 1) == expected - 1;
    if (last) {
      __threadfence();
      *counter = 0;                        // ready for the next launch
    }
    s_last = last;
  }
  __syncthreads();
  if (!s_last) return;

  // the last split merges the partials in split order: m = max m_i,
  // then l = sum l_i e^(m_i - m) and acc likewise, summed over i in
  // order; MERGE partials' loads in flight at a time (they are
  // independent; the sums are not)
  const long long first = static_cast<long long>(bk) * pl.n_split;
  for (int o = tid; o < O; o += THREADS) {
    const int g = o / D4;
    float m = NEG_INF;
    for (int i0 = 0; i0 < expected; i0 += MERGE) {
      float mi[MERGE];
#pragma unroll
      for (int u = 0; u < MERGE; ++u)
        mi[u] = i0 + u < expected ? __ldcg(ml_ws + (first + i0 + u) * 2 * G + g)
                                  : NEG_INF;
#pragma unroll
      for (int u = 0; u < MERGE; ++u) m = fmaxf(m, mi[u]);
    }
    float l = 0.0f;
    float4 a = f4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int i0 = 0; i0 < expected; i0 += MERGE) {
      float f[MERGE], li[MERGE];
      float4 ai[MERGE];
#pragma unroll
      for (int u = 0; u < MERGE; ++u) {
        if (i0 + u < expected) {
          const long long part_i = first + i0 + u;
          f[u] = __ldcg(ml_ws + part_i * 2 * G + g);
          li[u] = __ldcg(ml_ws + part_i * 2 * G + G + g);
          ai[u] = __ldcg(reinterpret_cast<const float4*>(acc_ws + part_i * G * D) + o);
        }
      }
#pragma unroll
      for (int u = 0; u < MERGE; ++u) {
        if (i0 + u < expected) {
          const float w = expf(f[u] - m);
          l = fmaf(li[u], w, l);
          a = f4(fmaf(ai[u].x, w, a.x), fmaf(ai[u].y, w, a.y),
                 fmaf(ai[u].z, w, a.z), fmaf(ai[u].w, w, a.w));
        }
      }
    }
    const float inv = 1.0f / fmaxf(l, 1e-30f);
    reinterpret_cast<float4*>(ob)[o] = f4(a.x * inv, a.y * inv, a.z * inv, a.w * inv);
  }
}

// ---------------------------------------------------------------------------
// The wide-group route (G = 16 query heads on a KV head: RecurrentGemma's
// MQA): both products on mma.sync m16n8k8 in 3xTF32, the 16 heads as mma's
// M, and the splits merged by a second kernel.
// ---------------------------------------------------------------------------

constexpr int WIDE_G = 16;           // mma's M
constexpr int WIDE_NT = 4;           // score n-tiles a warp at most (chunk <= 128)
constexpr int WIDE_NV = 8;           // p.V n-tiles a warp at most (head_dim <= 256)
constexpr int WIDE_SC = 8;           // score chains of the hi.hi terms
constexpr int WIDE_PC = 4;           // p.V chains of the hi.hi terms
constexpr size_t WIDE_MAX_SMEM = 200 * 1024;   // opted into once (+ 2 KB static)

// Shared memory of a wide-route CTA in bytes (host and device agree): q
// (16 rows of D + 4 floats), K rows of krow bytes (an odd multiple of 16),
// V rows of vrow bytes (fp32: D * 4 + 32, so that a B fragment read down
// V's columns hits 32 banks; else krow), the probabilities (16 rows of
// chunk + 4 floats), m, l, and the int8 scales.
struct WideSmem {
  int krow, vrow;
  size_t k, v, p, m, l, ksc, vsc, total;
};

__host__ __device__ inline WideSmem wide_layout(int D, int C, int elem, bool scaled) {
  WideSmem s;
  int r16 = (D * elem + 15) / 16;
  if (r16 % 2 == 0) ++r16;
  s.krow = 16 * r16;
  s.vrow = elem == 4 ? D * 4 + 32 : s.krow;
  s.k = sizeof(float) * WIDE_G * (D + 4);
  s.v = s.k + static_cast<size_t>(C) * s.krow;
  s.p = s.v + static_cast<size_t>(C) * s.vrow;
  s.m = s.p + sizeof(float) * WIDE_G * (C + 4);
  s.l = s.m + sizeof(float) * WIDE_G;
  s.ksc = s.l + sizeof(float) * WIDE_G;
  s.vsc = s.ksc + (scaled ? sizeof(float) * C : 0);
  s.total = s.vsc + (scaled ? sizeof(float) * C : 0);
  return s;
}

__device__ __forceinline__ float elem_f32(float x) { return x; }
__device__ __forceinline__ float elem_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float elem_f32(int8_t x) { return static_cast<float>(x); }

// One CTA: a (lane, KV head, chunk).  Steps 1-2 of the FFMA route (page
// ids, valid_len, the staged q, K, V and scales; V's rows from n up to the
// next multiple of 8 zeroed), then
//  3. s (16 heads x chunk): warp w owns slots [w C / 4, (w + 1) C / 4) in
//     n-tiles of 8; over the head_dim's k-steps of 8, q's A fragment and
//     K's B fragments split hi/lo in registers, each k-step's small
//     products (lo.hi, hi.lo; K from bf16 or int8 is exact and drops
//     hi.lo) on one accumulator and its hi.hi product on chain k % 8, the
//     chains added in fp32, then the small terms;
//  4. the softmax as the FFMA route, one warp per head;
//  5. p.V (16 heads x D): warp w owns columns [w D / 4, (w + 1) D / 4),
//     the chunk's ceil(n / 8) k-steps the same way, hi.hi on chain k % 4;
//  6. one split a lane: the output; else its partial (m, l, acc), which
//     decode_merge_wide merges.
template <typename T, bool SCALED, bool PAGED>
__global__ void __launch_bounds__(THREADS, 1)
decode_attn_wide(const float* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ ks,
                 const float* __restrict__ vs, const int* __restrict__ page_table,
                 const int* __restrict__ valid_len, float* __restrict__ out,
                 const DlkDecodePlan pl) {
  constexpr int G = WIDE_G;
  constexpr bool EXACT = !std::is_same<T, float>::value;   // bf16, int8: exact in TF32
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ long long page_off[MAX_CHUNK], cpage_off[MAX_CHUNK];
  const int D = pl.D, C = pl.chunk, ps = pl.slots;
  const int bk = blockIdx.x, chunk_id = blockIdx.y;
  const int b = bk / pl.KV, kvh = bk - b * pl.KV;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int t0 = chunk_id * C;
  float* ob = out + static_cast<long long>(bk) * G * D;

  const int npages = PAGED ? (C >= ps ? C / ps : 1) : 0;
  const int page0 = PAGED ? t0 / ps : 0;
  int pid = -1;
  if (PAGED && tid < npages && page0 + tid < pl.W)
    pid = page_table[static_cast<long long>(b) * pl.W + page0 + tid];
  int valid = valid_len[b];
  if (valid < 1) {   // outside the contract (valid_len >= 1): poison the lane
    if (chunk_id == 0)
      for (int i = tid; i < G * D; i += THREADS) ob[i] = nanf("");
    return;
  }
  valid = min(valid, PAGED ? pl.W * ps : pl.slots);
  if (t0 >= valid) return;                 // an empty split
  const int n = min(C, valid - t0);        // slots of this chunk in the prefix
  const int n8 = (n + 7) / 8 * 8;
  const bool multi = valid > C;

  const WideSmem lay = wide_layout(D, C, sizeof(T), SCALED);
  const int QS = D + 4, PS = C + 4;
  float* q_s = reinterpret_cast<float*>(smem);
  unsigned char* k_s = smem + lay.k;
  unsigned char* v_s = smem + lay.v;
  float* p_s = reinterpret_cast<float*>(smem + lay.p);
  float* m_s = reinterpret_cast<float*>(smem + lay.m);
  float* l_s = reinterpret_cast<float*>(smem + lay.l);
  float* ksc = reinterpret_cast<float*>(smem + lay.ksc);
  float* vsc = reinterpret_cast<float*>(smem + lay.vsc);

  const float* qb = q + static_cast<long long>(bk) * G * D;
  for (int i = tid; i < G * D / 4; i += THREADS) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    dlk_cp_async16(q_s + r * QS + c, qb + 4 * i, true);
  }
  if (PAGED) {
    if (tid < npages) {
      const bool ok = pid >= 0 && pid < pl.n_outer;
      page_off[tid] = ok ? pid * pl.s_outer + kvh * pl.s_head : -1;
      cpage_off[tid] = ok ? pid * pl.c_outer + kvh * pl.c_head : -1;
    }
    __syncthreads();
  }
  const int vw = pl.vw;
  const int row_vecs = D * static_cast<int>(sizeof(T)) / vw;
  const int lanes = min(row_vecs, THREADS);
  const int rows_per_pass = THREADS / lanes;
  const int vl = tid % lanes, r0 = tid / lanes;
  const int in_page0 = PAGED && C < ps ? t0 % ps : 0;
  auto stage = [&](const T* src, const float* sc, unsigned char* dst, int row,
                   float* sc_dst) {
    for (int s = r0; s < n && r0 < rows_per_pass; s += rows_per_pass) {
      long long off, coff;
      bool ok = true;
      if (PAGED) {
        const int j = C >= ps ? s / ps : 0;
        const int o = C >= ps ? s - j * ps : in_page0 + s;
        ok = page_off[j] >= 0;
        off = page_off[j] + o * pl.s_slot;
        coff = cpage_off[j] + o * pl.c_slot;
      } else {
        off = b * pl.s_outer + kvh * pl.s_head + (t0 + s) * pl.s_slot;
        coff = b * pl.c_outer + kvh * pl.c_head + (t0 + s) * pl.c_slot;
      }
      unsigned char* d = dst + s * row;
      if (ok) {
        const unsigned char* gp = reinterpret_cast<const unsigned char*>(src + off);
        for (int e = vl; e < row_vecs; e += lanes) copy_async(d + e * vw, gp + e * vw, vw);
        if (SCALED && vl == 0) dlk_cp_async4(sc_dst + s, sc + coff, true);
      } else {                             // a page id outside the pool
        for (int e = vl; e < row_vecs; e += lanes) fill_nan(d + e * vw, vw);
        if (SCALED && vl == 0) sc_dst[s] = nanf("");
      }
    }
    dlk_cp_async_commit();
  };
  stage(k, ks, k_s, lay.krow, ksc);
  stage(v, vs, v_s, lay.vrow, vsc);
  // V rows [n, n8): zeros, so that p = 0 there meets no stale NaN
  for (int i = tid; i < (n8 - n) * lay.vrow; i += THREADS) v_s[n * lay.vrow + i] = 0;
  if (SCALED)
    for (int s = n + tid; s < n8; s += THREADS) vsc[s] = 0.0f;
  dlk_cp_async_wait<1>();                  // q and K have landed
  __syncthreads();

  // 3. scores
  {
    const int nt = C / 32;                 // n-tiles a warp
    float sm[WIDE_NT][4], c[WIDE_SC][WIDE_NT][4];
#pragma unroll
    for (int j = 0; j < WIDE_NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sm[j][e] = 0.0f;
#pragma unroll
        for (int ch = 0; ch < WIDE_SC; ++ch) c[ch][j][e] = 0.0f;
      }
    const int s_w = warp * (C / 4);
#pragma unroll 1
    for (int d0 = 0; d0 < D; d0 += 8 * WIDE_SC) {
#pragma unroll
      for (int ch = 0; ch < WIDE_SC; ++ch) {
        const int dk = d0 + 8 * ch;
        if (dk >= D) continue;
        const float* qa = q_s + g * QS + dk + t;
        Frag<4> a;
        split(a, 0, qa[0]);
        split(a, 1, qa[8 * QS]);
        split(a, 2, qa[4]);
        split(a, 3, qa[8 * QS + 4]);
#pragma unroll
        for (int j = 0; j < WIDE_NT; ++j) {
          if (j < nt && s_w + 8 * j < n) {
            const T* kr = reinterpret_cast<const T*>(k_s + (s_w + 8 * j + g) * lay.krow) + dk + t;
            Frag<2> bb;
            split(bb, 0, elem_f32(kr[0]));
            split(bb, 1, elem_f32(kr[4]));
            mma_tf32(sm[j], a.lo, bb.hi);
            if constexpr (!EXACT) mma_tf32(sm[j], a.hi, bb.lo);
            mma_tf32(c[ch][j], a.hi, bb.hi);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < WIDE_NT; ++j) {
      if (j < nt && s_w + 8 * j < n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int head = g + 8 * (e >> 1), s = s_w + 8 * j + 2 * t + (e & 1);
          float x = c[0][j][e];
#pragma unroll
          for (int ch = 1; ch < WIDE_SC; ++ch) x += c[ch][j][e];
          x = (x + sm[j][e]) * pl.scale;
          if (SCALED) x *= ksc[s];
          if (s < n) p_s[head * PS + s] = x;
        }
      }
    }
  }
  __syncthreads();

  // 4. softmax within the chunk, one warp per head; p = 0 on [n, n8)
  for (int h = warp; h < G; h += WARPS) {
    float* row = p_s + h * PS;
    float mx = NEG_INF;
    for (int s = lane; s < n; s += 32) mx = fmaxf(mx, row[s]);
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
    float sum = 0.0f;
    for (int s = lane; s < n8; s += 32) {
      const float p = s < n ? expf(row[s] - mx) : 0.0f;
      sum += p;                            // l takes p before the V scale
      row[s] = SCALED ? p * vsc[s] : p;
    }
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(FULL, sum, o);
    if (lane == 0) {
      m_s[h] = mx;
      l_s[h] = sum;
    }
  }
  dlk_cp_async_wait<0>();                  // V has landed
  __syncthreads();

  // 5. p.V on this warp's D / 4 columns
  const int nv = D / 32;                   // n-tiles a warp
  const int c_w = warp * (D / 4);
  float psm[WIDE_NV][4], acc[WIDE_PC][WIDE_NV][4];
#pragma unroll
  for (int j = 0; j < WIDE_NV; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      psm[j][e] = 0.0f;
#pragma unroll
      for (int ch = 0; ch < WIDE_PC; ++ch) acc[ch][j][e] = 0.0f;
    }
#pragma unroll 1
  for (int k0 = 0; k0 < n8; k0 += 8 * WIDE_PC) {
#pragma unroll
    for (int ch = 0; ch < WIDE_PC; ++ch) {
      const int kk = k0 + 8 * ch;
      if (kk >= n8) continue;
      const float* pa = p_s + g * PS + kk + t;
      Frag<4> a;
      split(a, 0, pa[0]);
      split(a, 1, pa[8 * PS]);
      split(a, 2, pa[4]);
      split(a, 3, pa[8 * PS + 4]);
      const T* v0 = reinterpret_cast<const T*>(v_s + (kk + t) * lay.vrow) + c_w + g;
      const T* v1 = reinterpret_cast<const T*>(v_s + (kk + t + 4) * lay.vrow) + c_w + g;
#pragma unroll
      for (int j = 0; j < WIDE_NV; ++j) {
        if (j < nv) {
          Frag<2> bb;
          split(bb, 0, elem_f32(v0[8 * j]));
          split(bb, 1, elem_f32(v1[8 * j]));
          mma_tf32(psm[j], a.lo, bb.hi);
          if constexpr (!EXACT) mma_tf32(psm[j], a.hi, bb.lo);
          mma_tf32(acc[ch][j], a.hi, bb.hi);
        }
      }
    }
  }

  // 6. the output (heads g, g + 8; columns c_w + 8 j + 2 t, + 1), or the
  // partial
  float* acc_ws = pl.ws + (pl.B * pl.KV + 3) / 4 * 4;
  float* ml_ws = acc_ws + static_cast<long long>(pl.B) * pl.KV * pl.n_split * G * D;
  const long long part = static_cast<long long>(bk) * pl.n_split + chunk_id;
  float* dst = multi ? acc_ws + part * G * D : ob;
#pragma unroll
  for (int j = 0; j < WIDE_NV; ++j) {
    if (j < nv) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int head = g + 8 * hh;
        float x = acc[0][j][2 * hh], y = acc[0][j][2 * hh + 1];
#pragma unroll
        for (int ch = 1; ch < WIDE_PC; ++ch) {
          x += acc[ch][j][2 * hh];
          y += acc[ch][j][2 * hh + 1];
        }
        x += psm[j][2 * hh];
        y += psm[j][2 * hh + 1];
        if (!multi) {
          const float inv = 1.0f / fmaxf(l_s[head], 1e-30f);
          x *= inv;
          y *= inv;
        }
        *reinterpret_cast<float2*>(dst + head * D + c_w + 8 * j + 2 * t) = make_float2(x, y);
      }
    }
  }
  if (multi && tid < G) {
    ml_ws[part * 2 * G + tid] = m_s[tid];
    ml_ws[part * 2 * G + G + tid] = l_s[tid];
  }
}

// The wide route's merge: a thread per 4 outputs of a (lane, KV head), its
// splits' partials in split order (m = max m_i, then l = sum l_i e^(m_i -
// m) and acc likewise), so the lane's CTAs of this kernel share the reads.
// Lanes with one split (their output is written) or valid_len < 1 (NaN)
// are left alone.
__global__ void __launch_bounds__(THREADS)
decode_merge_wide(const int* __restrict__ valid_len, float* __restrict__ out,
                  const DlkDecodePlan pl) {
  constexpr int G = WIDE_G;
  const int D = pl.D, D4 = D / 4;
  const int bk = blockIdx.x, o = blockIdx.y * THREADS + threadIdx.x;
  if (o >= G * D4) return;
  int valid = valid_len[bk / pl.KV];
  if (valid < 1) return;
  valid = min(valid, pl.W * pl.slots);     // the capacity (ring: W = 1)
  const int expected = (valid + pl.chunk - 1) / pl.chunk;
  if (expected < 2) return;
  const float* acc_ws = pl.ws + (pl.B * pl.KV + 3) / 4 * 4;
  const float* ml_ws = acc_ws + static_cast<long long>(pl.B) * pl.KV * pl.n_split * G * D;
  const long long first = static_cast<long long>(bk) * pl.n_split;
  const int g = o / D4;
  float m = NEG_INF;
  for (int i = 0; i < expected; ++i) m = fmaxf(m, __ldcg(ml_ws + (first + i) * 2 * G + g));
  float l = 0.0f;
  float4 a = f4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int i0 = 0; i0 < expected; i0 += MERGE) {
    float f[MERGE], li[MERGE];
    float4 ai[MERGE];
#pragma unroll
    for (int u = 0; u < MERGE; ++u) {
      if (i0 + u < expected) {
        const long long part_i = first + i0 + u;
        f[u] = __ldcg(ml_ws + part_i * 2 * G + g);
        li[u] = __ldcg(ml_ws + part_i * 2 * G + G + g);
        ai[u] = __ldcg(reinterpret_cast<const float4*>(acc_ws + part_i * G * D) + o);
      }
    }
#pragma unroll
    for (int u = 0; u < MERGE; ++u) {
      if (i0 + u < expected) {
        const float w = expf(f[u] - m);
        l = fmaf(li[u], w, l);
        a = f4(fmaf(ai[u].x, w, a.x), fmaf(ai[u].y, w, a.y), fmaf(ai[u].z, w, a.z),
               fmaf(ai[u].w, w, a.w));
      }
    }
  }
  const float inv = 1.0f / fmaxf(l, 1e-30f);
  reinterpret_cast<float4*>(out + static_cast<long long>(bk) * G * D)[o] =
      f4(a.x * inv, a.y * inv, a.z * inv, a.w * inv);
}

template <typename T, bool SCALED, bool PAGED>
int launch_wide(const float* q, const void* k, const void* v, const float* ks,
                const float* vs, const int* pt, const int* valid, float* out,
                const DlkDecodePlan* pl, cudaStream_t stream) {
  static DlkSmemOnce once;
  const size_t smem = wide_layout(pl->D, pl->chunk, sizeof(T), SCALED).total;
  auto kern = decode_attn_wide<T, SCALED, PAGED>;
  if (pl->G != WIDE_G || pl->D % 32 || pl->D > 32 * WIDE_NV || pl->chunk % 32 ||
      pl->chunk > 32 * WIDE_NT || smem > WIDE_MAX_SMEM)
    return static_cast<int>(cudaErrorInvalidValue);
  if (int err = dlk_prepare_smem(kern, WIDE_MAX_SMEM, once)) return err;
  const unsigned lanes = static_cast<unsigned>(pl->B) * pl->KV;
  kern<<<dim3(lanes, static_cast<unsigned>(pl->n_split)), THREADS, smem, stream>>>(
      q, static_cast<const T*>(k), static_cast<const T*>(v), ks, vs, pt, valid,
      out, *pl);
  if (int err = dlk_last_error()) return err;
  if (pl->n_split > 1) {
    const unsigned blocks = (WIDE_G * pl->D / 4 + THREADS - 1) / THREADS;
    decode_merge_wide<<<dim3(lanes, blocks), THREADS, 0, stream>>>(valid, out, *pl);
  }
  return dlk_last_error();
}

template <typename T, bool SCALED, bool PAGED>
int launch(const float* q, const void* k, const void* v, const float* ks,
           const float* vs, const int* pt, const int* valid, float* out,
           const DlkDecodePlan* pl, cudaStream_t stream) {
  if (pl->wide)
    return launch_wide<T, SCALED, PAGED>(q, k, v, ks, vs, pt, valid, out, pl, stream);
  static DlkSmemOnce once;
  const size_t smem = smem_layout(pl->G, pl->D, pl->chunk, sizeof(T), SCALED).total;
  auto kern = decode_attn_split<T, SCALED, PAGED>;
  if (smem > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {   // the size varies by call: ask once for the most
    if (int err = dlk_prepare_smem(kern, MAX_SMEM, once)) return err;
  }
  const dim3 grid(static_cast<unsigned>(pl->B) * pl->KV,
                  static_cast<unsigned>(pl->n_split));
  kern<<<grid, THREADS, smem, stream>>>(
      q, static_cast<const T*>(k), static_cast<const T*>(v), ks, vs, pt, valid,
      out, *pl);
  return dlk_last_error();
}

}  // namespace

// out (B, KV*G, D) fp32 = attention of q (B, KV*G, D) fp32 over slots
// [0, valid[b]) of the ring caches k, v (B lanes of S slots, KV heads),
// fp32 or bf16 by pl->dtype.
extern "C" int dlk_decode_attention(const float* q, const void* k,
                                    const void* v, const float* ks,
                                    const float* vs, const int* pt,
                                    const int* valid, float* out,
                                    const DlkDecodePlan* pl,
                                    cudaStream_t stream) {
  if (pl->dtype == DLK_BF16)
    return launch<__nv_bfloat16, false, false>(q, k, v, ks, vs, pt, valid,
                                               out, pl, stream);
  return launch<float, false, false>(q, k, v, ks, vs, pt, valid, out, pl,
                                     stream);
}

// The same over int8 ring caches with one fp32 scale per (lane, head, slot).
extern "C" int dlk_decode_attention_q8(const float* q, const void* k,
                                       const void* v, const float* ks,
                                       const float* vs, const int* pt,
                                       const int* valid, float* out,
                                       const DlkDecodePlan* pl,
                                       cudaStream_t stream) {
  return launch<int8_t, true, false>(q, k, v, ks, vs, pt, valid, out, pl,
                                     stream);
}

// The same over page pools (P pages of ps slots) through page_table (B, W).
extern "C" int dlk_decode_attention_paged(const float* q, const void* k,
                                          const void* v, const float* ks,
                                          const float* vs, const int* pt,
                                          const int* valid, float* out,
                                          const DlkDecodePlan* pl,
                                          cudaStream_t stream) {
  if (pl->dtype == DLK_BF16)
    return launch<__nv_bfloat16, false, true>(q, k, v, ks, vs, pt, valid, out,
                                              pl, stream);
  return launch<float, false, true>(q, k, v, ks, vs, pt, valid, out, pl,
                                    stream);
}

// Paged int8 pools with their per-slot fp32 scale pools.
extern "C" int dlk_decode_attention_paged_q8(const float* q, const void* k,
                                             const void* v, const float* ks,
                                             const float* vs, const int* pt,
                                             const int* valid, float* out,
                                             const DlkDecodePlan* pl,
                                             cudaStream_t stream) {
  return launch<int8_t, true, true>(q, k, v, ks, vs, pt, valid, out, pl,
                                    stream);
}
