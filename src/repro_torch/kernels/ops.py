"""Public wrappers for every kernel, and their launch counts.

The counterpart of ``repro.kernels.ops``.  Each wrapper takes its plain
version for a CPU tensor and launches its CUDA kernel for a CUDA tensor.
``KERNELS`` maps each C entry point's name to its :class:`CudaKernel`;
each ``launches`` count shows that a run went through it.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.kernels import conv2d as _conv
from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import elementwise as _ew
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import int8_matmul as _i8
from repro_torch.kernels import matmul as _mm
from repro_torch.kernels import pool as _pool
from repro_torch.kernels import rwkv6_chunk as _rwkv
from repro_torch.kernels import softmax as _sm
from repro_torch.kernels._build import CudaKernel
from repro_torch.kernels.conv2d import conv2d
from repro_torch.kernels.decode_attention import (
    decode_attention, decode_attention_paged, decode_attention_paged_q8,
    decode_attention_q8)
from repro_torch.kernels.elementwise import elementwise, relu, relu_
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention_bwd import flash_attention_trainable
from repro_torch.kernels.int8_matmul import int8_matmul
from repro_torch.kernels.matmul import matmul
from repro_torch.kernels.pool import pool2d
from repro_torch.kernels.rwkv6_chunk import rwkv6_chunked
from repro_torch.kernels.softmax import softmax

__all__ = ["KERNELS", "conv2d", "decode_attention", "decode_attention_paged",
           "decode_attention_paged_q8", "decode_attention_q8", "drop_meta",
           "elementwise", "flash_attention", "flash_attention_trainable",
           "int8_matmul", "launches", "matmul", "pool2d", "relu", "relu_",
           "reset_launches", "rwkv6_chunked", "softmax"]

KERNELS: Dict[str, CudaKernel] = {
    "matmul": _mm.KERNEL,
    "conv2d": _conv.KERNEL,
    "pool2d": _pool.KERNEL,
    "elementwise": _ew.KERNEL,
    "softmax": _sm.KERNEL,
    "decode_attention": _da.RING,
    "decode_attention_q8": _da.RING_Q8,
    "decode_attention_paged": _da.PAGED,
    "decode_attention_paged_q8": _da.PAGED_Q8,
    "flash_attention": _fa.FWD,              # B8
    "flash_attention_fwd": _fa.FWD_LSE,      # B9: forward with lse
    "flash_attention_dq": _fa.DQ,            # B9: dq
    "flash_attention_dkv": _fa.DKV,          # B9: dk/dv
    "rwkv6_chunked": _rwkv.KERNEL,           # B10
    "int8_matmul": _i8.KERNEL,               # B11
}


def launches() -> Dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


def reset_launches() -> None:
    for k in KERNELS.values():
        k.launches = 0


def drop_meta() -> None:
    """Forget the buffers the wrappers keep for meta tensors (B6/B7's
    workspaces, B10's records), so that a memory count sees them made."""
    _da.drop_meta()
    _rwkv.drop_meta()
