// Shared pieces of the kernel library: activation codes (the same numbers
// as ACT_CODES in repro_torch/kernels/elementwise.py), the activations in
// fp32, and the error return every C entry point ends with.
#pragma once

#include <cuda_runtime.h>

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

// Every entry point returns this: a launch refused for its configuration
// never runs, and only cudaGetLastError reports it.
static inline int dlk_last_error() { return static_cast<int>(cudaGetLastError()); }
