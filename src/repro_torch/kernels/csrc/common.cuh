// Shared pieces of the kernel library: activation codes (the same numbers
// as ACT_CODES in repro_torch/kernels/elementwise.py), the activations in
// fp32, cp.async copies, the error return every C entry point ends with,
// and the opt-in to more than 48 KB of dynamic shared memory.
#pragma once

#include <cuda_runtime.h>

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
