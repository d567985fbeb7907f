"""Public wrappers for every kernel, and their launch counts.

The counterpart of ``repro.kernels.ops``.  Each wrapper takes its plain
version for a CPU tensor and launches its CUDA kernel for a CUDA tensor.
``KERNELS`` maps each C entry point's name to its :class:`CudaKernel`,
and conv2d (im2col + the matmul launch) to its own count; each
``launches`` count shows that a run went through it.
"""
from __future__ import annotations

from typing import Dict, Union

from repro_torch.kernels import conv2d as _conv
from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import elementwise as _ew
from repro_torch.kernels import matmul as _mm
from repro_torch.kernels import pool as _pool
from repro_torch.kernels import softmax as _sm
from repro_torch.kernels._build import CompositeKernel, CudaKernel
from repro_torch.kernels.conv2d import conv2d
from repro_torch.kernels.decode_attention import (
    decode_attention, decode_attention_paged, decode_attention_paged_q8,
    decode_attention_q8)
from repro_torch.kernels.elementwise import elementwise, relu
from repro_torch.kernels.matmul import matmul
from repro_torch.kernels.pool import pool2d
from repro_torch.kernels.softmax import softmax

__all__ = ["KERNELS", "conv2d", "decode_attention", "decode_attention_paged",
           "decode_attention_paged_q8", "decode_attention_q8", "elementwise",
           "launches", "matmul", "pool2d", "relu", "reset_launches",
           "softmax"]

KERNELS: Dict[str, Union[CudaKernel, CompositeKernel]] = {
    "matmul": _mm.KERNEL,
    "conv2d": _conv.KERNEL,
    "pool2d": _pool.KERNEL,
    "elementwise": _ew.KERNEL,
    "softmax": _sm.KERNEL,
    "decode_attention": _da.RING,
    "decode_attention_q8": _da.RING_Q8,
    "decode_attention_paged": _da.PAGED,
    "decode_attention_paged_q8": _da.PAGED_Q8,
}


def launches() -> Dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


def reset_launches() -> None:
    for k in KERNELS.values():
        k.launches = 0
