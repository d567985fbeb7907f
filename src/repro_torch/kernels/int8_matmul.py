"""B11: int8 matrix product with per-row and per-column dequantization.

Kernel: ``csrc/int8_matmul.cu`` (replaces repro/kernels/int8_matmul.py
``int8_matmul``).  The int8 operands multiply into an int32 sum and the
scales apply once, in the epilogue; its feed is the model store's
``QTensor`` (int8 weights with an fp32 scale per output column).  A CPU
tensor takes the plain version in ``repro_torch.kernels.ref``; a CUDA
tensor launches the kernel or raises.

The int32 sum is exact, so the kernel equals its plain version bit for
bit, up to K = 133,144: from K = 133,145 on, 127 * 127 * K can pass
2^31 - 1 and the sum wraps, as the TPU kernel's (and XLA's) does.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import CudaKernel
from repro_torch.kernels.ref import int8_matmul_ref

KERNEL = CudaKernel("dlk_int8_matmul",
                    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3)

_INT_MAX = 2 ** 31 - 1
_TILE, _MAX_GRID_Y = 64, 65535


def int8_matmul(a_q: torch.Tensor, b_q: torch.Tensor, a_scale: torch.Tensor,
                b_scale: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 -> (M, N) fp32, scaled by a_scale (M,)
    and b_scale (N,), both fp32."""
    if a_q.ndim != 2 or b_q.ndim != 2 or a_q.shape[1] != b_q.shape[0]:
        raise ValueError(f"int8_matmul: shapes {tuple(a_q.shape)} @ "
                         f"{tuple(b_q.shape)}")
    m, k = a_q.shape
    n = b_q.shape[1]
    if a_q.dtype != torch.int8 or b_q.dtype != torch.int8:
        raise TypeError(f"int8_matmul: operands must be int8, got "
                        f"{a_q.dtype} and {b_q.dtype}")
    if a_scale.dtype != torch.float32 or b_scale.dtype != torch.float32:
        raise TypeError(f"int8_matmul: scales must be float32, got "
                        f"{a_scale.dtype} and {b_scale.dtype}")
    if tuple(a_scale.shape) != (m,) or tuple(b_scale.shape) != (n,):
        raise ValueError(f"int8_matmul: scales {tuple(a_scale.shape)} and "
                         f"{tuple(b_scale.shape)} for M={m}, N={n}")
    if a_q.device.type == "cpu":
        return int8_matmul_ref(a_q, b_q, a_scale, b_scale)
    dev = a_q.device
    tensors = (a_q, b_q, a_scale, b_scale)
    if any(t.device.type != "cuda" or t.device != dev for t in tensors):
        raise ValueError(f"int8_matmul: tensors must share one CUDA device, "
                         f"got {[str(t.device) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("int8_matmul: operands and scales must be "
                         "row-major contiguous")
    if max(m, n, k) > _INT_MAX or -(-m // _TILE) > _MAX_GRID_Y:
        raise ValueError(f"int8_matmul: M={m}, N={n}, K={k} out of range")
    out = torch.empty((m, n), device=dev, dtype=torch.float32)
    if m and n:
        KERNEL.launch(a_q.get_device(), a_q.data_ptr(), b_q.data_ptr(),
                      a_scale.data_ptr(), b_scale.data_ptr(), out.data_ptr(),
                      m, n, k)
    return out
