"""B4: elementwise activation — the paper's rectifier shader on Hopper.

Kernel: ``csrc/elementwise.cu`` (replaces repro/kernels/elementwise.py
``elementwise``), one launch for any size.  :func:`elementwise` and
:func:`relu` write a new tensor; :func:`relu_` writes into its input, for
the graph's in-place ReLU (``core/graph.py``).  The common call (fp32,
CUDA, contiguous) takes one check; anything else goes the slow way, which
raises the errors.  A CPU tensor takes the plain version in
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

_CODES = {act: ACT_CODES[act] for act in ACTS}   # the activations B4 takes
_RELU = ACT_CODES["relu"]
_F32 = torch.float32


def elementwise(x: torch.Tensor, act: str = "relu") -> torch.Tensor:
    """act(x) elementwise, computed in fp32, into a new tensor."""
    code = _CODES.get(act)
    if code is None or not x.is_cuda or x.dtype is not _F32 \
            or not x.is_contiguous():
        return _checked(x, act, inplace=False)
    return _launch(x, torch.empty_like(x), code)


def relu(x: torch.Tensor) -> torch.Tensor:
    return elementwise(x, "relu")


def relu_(x: torch.Tensor) -> torch.Tensor:
    """ReLU written into ``x``; returns ``x``."""
    if not x.is_cuda or x.dtype is not _F32 or not x.is_contiguous():
        return _checked(x, "relu", inplace=True)
    return _launch(x, x, _RELU)


def _launch(x, out, code):
    n = x.numel()
    if n:
        KERNEL.launch(x.get_device(), x.data_ptr(), out.data_ptr(), n, code)
    return out


def _checked(x, act, inplace):
    """A CPU tensor, or a call to refuse."""
    if act not in ACTS:
        raise ValueError(f"unknown activation {act!r}; known: {sorted(ACTS)}")
    if x.is_cpu:
        return x.copy_(elementwise_ref(x, act)) if inplace \
            else elementwise_ref(x, act)
    check_cuda_f32("elementwise", x)
    if not x.is_contiguous():
        raise ValueError("elementwise: input must be contiguous")
    return _launch(x, x if inplace else torch.empty_like(x), _CODES[act])
