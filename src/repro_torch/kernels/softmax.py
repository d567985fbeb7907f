"""B5: numerically stable row softmax — the paper's softmax shader on Hopper.

Kernel: ``csrc/softmax.cu`` (replaces repro/kernels/softmax.py
``softmax``).  A CPU tensor takes the plain version in
``repro_torch.kernels.ref``; a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import CudaKernel, check_cuda_f32, ptr
from repro_torch.kernels.ref import softmax_ref

KERNEL = CudaKernel("dlk_softmax_f32",
                    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                     ctypes.c_int])


def softmax(x: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis of a 2D (R, N) tensor, in fp32."""
    if x.ndim != 2:
        raise ValueError(f"softmax: expected (R, N), got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return softmax_ref(x)
    check_cuda_f32("softmax", x)
    if not x.is_contiguous():
        raise ValueError("softmax: input must be contiguous")
    out = torch.empty_like(x)
    if x.numel():
        KERNEL.launch(x.device, ptr(x), ptr(out), x.shape[0], x.shape[1])
    return out
