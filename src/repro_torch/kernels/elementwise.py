"""B4: elementwise activation — the paper's rectifier shader on Hopper.

Kernel: ``csrc/elementwise.cu`` (replaces repro/kernels/elementwise.py
``elementwise``).  A CPU tensor takes the plain version in
``repro_torch.kernels.ref``; a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import CudaKernel, check_cuda_f32
from repro_torch.kernels.ref import ACTS, elementwise_ref

# the DlkAct codes of csrc/common.cuh
ACT_CODES = {"none": 0, "relu": 1, "silu": 2, "gelu": 3, "tanh": 4,
             "sigmoid": 5}

KERNEL = CudaKernel("dlk_elementwise_f32",
                    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                     ctypes.c_int])


def elementwise(x: torch.Tensor, act: str = "relu") -> torch.Tensor:
    """act(x) elementwise, computed in fp32."""
    if act not in ACTS:
        raise ValueError(f"unknown activation {act!r}; known: {sorted(ACTS)}")
    if x.is_cpu:
        return elementwise_ref(x, act)
    dev = check_cuda_f32("elementwise", x)
    if not x.is_contiguous():
        raise ValueError("elementwise: input must be contiguous")
    out = torch.empty_like(x)
    n = x.numel()
    if n:
        KERNEL.launch(dev, x.data_ptr(), out.data_ptr(), n, ACT_CODES[act])
    return out


def relu(x: torch.Tensor) -> torch.Tensor:
    return elementwise(x, "relu")
