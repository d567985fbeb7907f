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
// Design: split-KV.  The grid is (lane x KV head, split); split i owns the
// slots [i*C, (i+1)*C) of the lane's prefix, C (the chunk) fixed by the
// wrapper from the shapes (repro_torch/kernels/decode_attention.py::plan),
// never from valid_len, so a lane's output depends on its own K/V and
// valid_len alone.  A CTA whose chunk starts past the prefix exits at once.
// The G query heads of the KV head share each K/V row, as in the TPU
// kernel.  A CTA of 128 threads:
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
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

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

template <typename T, bool SCALED, bool PAGED>
int launch(const float* q, const void* k, const void* v, const float* ks,
           const float* vs, const int* pt, const int* valid, float* out,
           const DlkDecodePlan* pl, cudaStream_t stream) {
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
