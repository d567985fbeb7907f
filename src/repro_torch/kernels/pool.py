"""B3: max / average pooling — the paper's pooling shader on Hopper.

Kernel: ``csrc/pool.cu`` (replaces repro/kernels/pool.py ``pool2d``).  One
thread per output walks its window inside the bounds, so the input is not
padded.  A CPU tensor takes the plain version in
``repro_torch.kernels.ref``; a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import CudaKernel, check_cuda_f32
from repro_torch.kernels.ref import pool2d_ref

KERNEL = CudaKernel("dlk_pool2d_f32",
                    [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 9)


def pool2d(x: torch.Tensor, *, mode: str = "max", kernel: int = 2,
           stride: int = 2, pad: int = 0) -> torch.Tensor:
    """x: (B, C, H, W) -> (B, C, OH, OW); avg excludes padding (Caffe)."""
    if mode not in ("max", "avg"):
        raise ValueError(f"unknown pool mode {mode!r}")
    if x.ndim != 4:
        raise ValueError(f"pool2d: expected (B, C, H, W), got {tuple(x.shape)}")
    b, c, h, w = x.shape
    oh = (h + 2 * pad - kernel) // stride + 1
    ow = (w + 2 * pad - kernel) // stride + 1
    if oh <= 0 or ow <= 0 or kernel <= 0 or stride <= 0 or pad < 0:
        raise ValueError(f"pool2d: window {kernel}/{stride}/{pad} on {h}x{w}")
    if x.is_cpu:
        return pool2d_ref(x, mode=mode, kernel=kernel, stride=stride, pad=pad)
    dev = check_cuda_f32("pool2d", x)
    if not x.is_contiguous():
        raise ValueError("pool2d: input must be contiguous")
    out = x.new_empty((b, c, oh, ow))
    if b and c:
        KERNEL.launch(dev, x.data_ptr(), out.data_ptr(), b * c, h, w, oh, ow,
                      kernel, stride, pad, int(mode == "max"))
    return out
