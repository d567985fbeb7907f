"""B1: fp32 matrix product with a fused bias + activation epilogue.

Kernel: ``csrc/matmul.cu`` (replaces repro/kernels/matmul.py ``matmul``).
It reads A and B by strides and masks ragged edges itself, so neither
input is padded or copied.  A CPU tensor takes the plain version in
``repro_torch.kernels.ref``; a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels._build import CudaKernel, check_cuda_f32, ptr
from repro_torch.kernels.elementwise import ACT_CODES
from repro_torch.kernels.ref import matmul_ref

KERNEL = CudaKernel("dlk_matmul_f32",
                    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                    + [ctypes.c_longlong] * 4 + [ctypes.c_int])

_INT_MAX = 2 ** 31 - 1


def matmul(a: torch.Tensor, b: torch.Tensor,
           bias: Optional[torch.Tensor] = None, *,
           activation: str = "none") -> torch.Tensor:
    """a: (M, K) @ b: (K, N), + bias (N,), then the activation; fp32."""
    if activation not in ACT_CODES:
        raise ValueError(f"unknown activation {activation!r}")
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul: shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    m, k = a.shape
    n = b.shape[1]
    if bias is not None and tuple(bias.shape) != (n,):
        raise ValueError(f"matmul: bias {tuple(bias.shape)} for N={n}")
    if a.device.type == "cpu":
        return matmul_ref(a, b, bias, activation=activation)
    operands = (a, b) if bias is None else (a, b, bias)
    check_cuda_f32("matmul", *operands)
    if bias is not None and not bias.is_contiguous():
        raise ValueError("matmul: bias must be contiguous")
    if max(m, n, k) > _INT_MAX or min(*a.stride(), *b.stride()) < 0:
        raise ValueError("matmul: sizes must fit int32, strides be >= 0")
    out = torch.empty((m, n), device=a.device, dtype=torch.float32)
    if m and n:
        KERNEL.launch(a.device, ptr(a), ptr(b),
                      None if bias is None else ptr(bias), ptr(out),
                      m, n, k, a.stride(0), a.stride(1), b.stride(0),
                      b.stride(1), ACT_CODES[activation])
    return out
