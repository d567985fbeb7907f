// Shared pieces of the kernel library: activation codes (the same numbers
// as ACT_CODES in repro_torch/kernels/elementwise.py), the activations in
// fp32, cp.async copies, 3xTF32 fragments and mma.sync m16n8k8 TF32 (the
// flash backward and the wide-group decode), the error return every C
// entry point ends with, and the opt-in to more than 48 KB of dynamic
// shared memory.
#pragma once

#include <cuda_runtime.h>

#include <stdint.h>

#include <atomic>

enum DlkAct : int {
  DLK_ACT_NONE = 0,
  DLK_ACT_RELU = 1,
  DLK_ACT_SILU = 2,
  DLK_ACT_GELU = 3,   // tanh approximation, as jax.nn.gelu's default
  DLK_ACT_TANH = 4,
  DLK_ACT_SIGMOID = 5,
};

__device__ __forceinline__ float dlk_sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ float dlk_act(float x, int act) {
  switch (act) {
    case DLK_ACT_RELU:
      return x < 0.0f ? 0.0f : x;   // keeps NaN, as jnp.maximum does
    case DLK_ACT_SILU:
      return x * dlk_sigmoid(x);
    case DLK_ACT_GELU: {
      const float k = 0.7978845608028654f;   // sqrt(2 / pi)
      return x * (0.5f * (1.0f + tanhf(k * (x + 0.044715f * (x * x * x)))));
    }
    case DLK_ACT_TANH:
      return tanhf(x);
    case DLK_ACT_SIGMOID:
      return dlk_sigmoid(x);
    default:
      return x;
  }
}

// Asynchronous global -> shared copies of 4 and 16 bytes (zero-filled when
// !ok, and src then is never read), their commit and their wait.
__device__ __forceinline__ void dlk_cp_async4(float* dst, const float* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void dlk_cp_async16(float* dst, const float* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void dlk_cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Until at most N of this thread's committed groups are still in flight.
template <int N>
__device__ __forceinline__ void dlk_cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// An operand fragment as two TF32 parts, x = hi + lo to ~2^-21 relative:
// hi = rna(x), rna rounding to nearest, ties away from zero, in its
// integer form ((bits + 2^12) with the low 13 bits cleared: cvt.rna.tf32's
// result for every finite x, in two integer operations), and lo = x - hi,
// exact in fp32, whose low 13 bits the tensor core ignores (lo truncated
// to TF32).  A NaN or an infinity in x gives a NaN lo, which reaches the
// product.
template <int N>
struct Frag {
  uint32_t hi[N], lo[N];
};

template <int N>
__device__ __forceinline__ void split(Frag<N>& f, int i, float x) {
  const uint32_t hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  f.hi[i] = hi;
  f.lo[i] = __float_as_uint(x - __uint_as_float(hi));
}

// c += a b on one m16n8k8 tile (TF32 in, fp32 accumulators).
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b in 3xTF32: lo(a) hi(b) + hi(a) lo(b) + hi(a) hi(b), the small
// terms first.  An operand exact in TF32 (bf16 data: its lo is 0) drops
// its term.
template <bool EXACT_A, bool EXACT_B>
__device__ __forceinline__ void mma3(float (&c)[4], const Frag<4>& a,
                                     const Frag<2>& b) {
  if constexpr (!EXACT_A) mma_tf32(c, a.lo, b.hi);
  if constexpr (!EXACT_B) mma_tf32(c, a.hi, b.lo);
  mma_tf32(c, a.hi, b.hi);
}

// Every entry point returns this: a launch refused for its configuration
// never runs, and only cudaGetLastError reports it.
static inline int dlk_last_error() { return static_cast<int>(cudaGetLastError()); }

// Above 48 KB a block's shared memory must be asked for: once per kernel
// and device, at its first launch there (each launcher keeps its own
// DlkSmemOnce in a function-local static).  max_carveout also asks for the
// largest shared-memory share of the SM's L1, for kernels that fit
// several such blocks an SM.
constexpr int DLK_MAX_DEVICES = 64;
struct DlkSmemOnce {
  std::atomic<bool> done[DLK_MAX_DEVICES];
};

template <typename K>
int dlk_prepare_smem(K kern, size_t smem, DlkSmemOnce& once,
                     bool max_carveout = false) {
  int dev = 0;
  if (cudaError_t err = cudaGetDevice(&dev)) return static_cast<int>(err);
  const bool known = dev < DLK_MAX_DEVICES;
  if (known && once.done[dev].load(std::memory_order_acquire)) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err == cudaSuccess && max_carveout)
    err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                               static_cast<int>(cudaSharedmemCarveoutMaxShared));
  if (err == cudaSuccess && known) once.done[dev].store(true, std::memory_order_release);
  return static_cast<int>(err);
}
