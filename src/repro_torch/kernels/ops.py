"""Public wrappers for every kernel, and their launch counts.

The counterpart of ``repro.kernels.ops``.  Each wrapper takes its plain
version for a CPU tensor and launches its CUDA kernel for a CUDA tensor.
``KERNELS`` maps a kernel's name to its :class:`CudaKernel`, whose
``launches`` count shows that a run went through it.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.kernels import elementwise as _ew
from repro_torch.kernels import matmul as _mm
from repro_torch.kernels import pool as _pool
from repro_torch.kernels import softmax as _sm
from repro_torch.kernels._build import CudaKernel
from repro_torch.kernels.conv2d import conv2d
from repro_torch.kernels.elementwise import elementwise, relu
from repro_torch.kernels.matmul import matmul
from repro_torch.kernels.pool import pool2d
from repro_torch.kernels.softmax import softmax

__all__ = ["KERNELS", "conv2d", "elementwise", "launches", "matmul",
           "pool2d", "relu", "reset_launches", "softmax"]

KERNELS: Dict[str, CudaKernel] = {
    "matmul": _mm.KERNEL,
    "pool2d": _pool.KERNEL,
    "elementwise": _ew.KERNEL,
    "softmax": _sm.KERNEL,
}


def launches() -> Dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


def reset_launches() -> None:
    for k in KERNELS.values():
        k.launches = 0
