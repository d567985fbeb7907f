"""B1: fp32 matrix product with a fused bias + activation epilogue.

Kernel: ``csrc/matmul.cu`` (replaces repro/kernels/matmul.py ``matmul``).
It reads A and B by strides and masks ragged edges itself, so neither
input is padded or copied.  Two routes, picked by :func:`plan` from the
shape and the SM count: the 64 x 64 tiled kernel for large M, and for
skinny products (M <= 16: the CNN's dense layers) a split-K kernel whose
(column strip, K slice) CTAs fill the card, its partial tiles summed in
split order by a second pass over a workspace.  A CPU tensor takes the
plain version in ``repro_torch.kernels.ref``; a CUDA tensor launches the
kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels._build import CudaKernel, check_cuda_f32, sm_count
from repro_torch.kernels.elementwise import ACT_CODES
from repro_torch.kernels.ref import matmul_ref

KERNEL = CudaKernel("dlk_matmul_f32",
                    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                    + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 2)

# the split-K kernel (csrc/matmul.cu): 64-column strips, at most 16 rows,
# a K slice of at most 1024 rows of B (its slice of A is staged in shared
# memory); slices at least MIN_SPAN deep; two CTAs an SM make a wave
SPLIT_COLS = 64
SPLIT_MAX_M = 16
MAX_SPAN = 1024
MIN_SPAN = 8
CTAS_PER_SM = 2
_INT_MAX = 2 ** 31 - 1
_PLANS: Dict[Tuple[int, int, int, int], int] = {}


def plan(m: int, n: int, k: int, sms: int) -> int:
    """The route of an (m, k) @ (k, n) product on ``sms`` SMs: 0 for the
    tiled kernel (m > 16, or k = 0), else the split-K kernel's number of
    K slices S.  S is chosen so that the (column strip, slice) CTAs make
    one wave of two CTAs on each SM, each slice at least MIN_SPAN and at
    most MAX_SPAN deep; the slices are ceil(k / S) deep and none is
    empty."""
    if m > SPLIT_MAX_M or k == 0:
        return 0
    strips = -(-n // SPLIT_COLS)
    s = min(-(-CTAS_PER_SM * sms // strips), max(1, k // MIN_SPAN))
    s = max(s, -(-k // MAX_SPAN))
    return -(-k // -(-k // s))


def workspace_floats(m: int, n: int, splits: int) -> int:
    """Floats of the split-K workspace: one m x n partial tile a slice
    (none for the tiled route)."""
    return splits * m * n


def _plan(m, n, k, index):
    key = (m, n, k, index)
    s = _PLANS.get(key)
    if s is None:
        s = _PLANS[key] = plan(m, n, k, sm_count(index))
    return s


def matmul(a: torch.Tensor, b: torch.Tensor,
           bias: Optional[torch.Tensor] = None, *,
           activation: str = "none") -> torch.Tensor:
    """a: (M, K) @ b: (K, N), + bias (N,), then the activation; fp32."""
    if a.is_cpu:
        _shape(a, b, bias, activation)
        return matmul_ref(a, b, bias, activation=activation)
    return launch(a, b, bias, activation=activation)


def _shape(a, b, bias, activation):
    if activation not in ACT_CODES:
        raise ValueError(f"unknown activation {activation!r}")
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul: shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    m, k = a.shape
    n = b.shape[1]
    if bias is not None and tuple(bias.shape) != (n,):
        raise ValueError(f"matmul: bias {tuple(bias.shape)} for N={n}")
    return m, n, k


def launch(a, b, bias=None, *, activation="none",
           splits: Optional[int] = None):
    """The kernel on CUDA tensors.  ``splits`` defaults to :func:`plan`;
    tests and the chip smoke pass it to hold both routes against the
    plain version.  One buffer holds the output and the workspace."""
    m, n, k = _shape(a, b, bias, activation)
    operands = (a, b) if bias is None else (a, b, bias)
    dev = check_cuda_f32("matmul", *operands)
    if bias is not None and not bias.is_contiguous():
        raise ValueError("matmul: bias must be contiguous")
    if max(m, n, k) > _INT_MAX or min(*a.stride(), *b.stride()) < 0:
        raise ValueError("matmul: sizes must fit int32, strides be >= 0")
    if splits is None:
        splits = _plan(m, n, k, dev)
    elif splits and (m > SPLIT_MAX_M or not 1 <= splits <= k
                     or (splits - 1) * -(-k // splits) >= k
                     or -(-k // splits) > MAX_SPAN):
        raise ValueError(f"matmul: {splits} K slices for {m} x {n} x {k}")
    buf = a.new_empty((1 + splits, m, n))
    out = buf[0]
    if m and n:
        ptr = out.data_ptr()
        KERNEL.launch(dev, a.data_ptr(), b.data_ptr(),
                      None if bias is None else bias.data_ptr(), ptr,
                      ptr + 4 * m * n if splits else None, m, n, k,
                      a.stride(0), a.stride(1), b.stride(0), b.stride(1),
                      ACT_CODES[activation], splits)
    return out
