"""B2: convolution as one implicit-GEMM kernel.

Kernel: ``csrc/conv2d.cu`` (replaces repro/kernels/conv2d.py ``conv2d``,
which is an XLA im2col feeding the Pallas matmul).  The kernel gathers the
patches as it loads them and stores NCHW directly, so neither the patch
matrix nor a transposed output is written to device memory.  When the
output tiles alone cannot fill the card, the depth is split
(:func:`split_count`, from the shape and the SM count) and the partial
tiles are summed in split order by a second pass over a workspace.  A
CPU tensor takes the plain version,
``repro_torch.kernels.ref.conv2d_im2col_ref`` (im2col + ``matmul_ref``,
the kernel's depth order step by step); a CUDA tensor launches the kernel
or raises.  ``F.conv2d`` and cuDNN are never on this path.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels._build import CudaKernel, check_cuda_f32, sm_count
from repro_torch.kernels.elementwise import ACT_CODES
from repro_torch.kernels.ref import conv2d_im2col_ref

KERNEL = CudaKernel("dlk_conv2d_f32",
                    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10)

# the kernel's tile (csrc/conv2d.cu): 64 output channels x 128 pixels,
# depth slabs of 16; at most 8 splits; two CTAs fit an SM (~100 registers
# a thread, at most 70 KB of shared memory at NIN's depths)
TILE_O, TILE_P, SLAB = 64, 128, 16
MAX_SPLITS = 8
CTAS_PER_SM = 2
MIN_SLABS = 4            # depth slabs each split walks at least
MAX_SPAN = 16384         # depth entries of one split's table in shared memory
_INT_MAX = 2 ** 31 - 1


def split_count(o: int, p: int, depth: int, sms: int) -> int:
    """Depth splits for an O x P output over ``depth``: as many as keep
    one wave of CTAs (two on each of ``sms`` SMs), at most 8, each split
    at least ``MIN_SLABS`` slabs deep, and enough that one split's depth
    table fits shared memory."""
    tiles = -(-o // TILE_O) * -(-p // TILE_P)
    slabs = -(-depth // SLAB)
    s = max(1, min(MAX_SPLITS, CTAS_PER_SM * sms // tiles,
                   slabs // MIN_SLABS))
    return max(s, -(-slabs // (MAX_SPAN // SLAB)))


def conv2d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
           *, stride: int = 1, pad: int = 0, activation: str = "none"
           ) -> torch.Tensor:
    """x: (B, C, H, W); w: (O, C, K, K) -> contiguous (B, O, OH, OW) =
    act(conv + b)."""
    if x.is_cpu:
        _shape(x, w, b, stride, pad, activation)
        return conv2d_im2col_ref(x, w, b, stride=stride, pad=pad,
                                 activation=activation)
    return launch(x, w, b, stride=stride, pad=pad, activation=activation)


def _shape(x, w, b, stride, pad, activation):
    """Validate from metadata; return (B, C, H, W, O, K, OH, OW)."""
    if activation not in ACT_CODES:
        raise ValueError(f"unknown activation {activation!r}")
    if x.ndim != 4 or w.ndim != 4 or w.shape[1] != x.shape[1] \
            or w.shape[2] != w.shape[3]:
        raise ValueError(f"conv2d: x (B,C,H,W) and w (O,C,K,K), got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    bsz, c, h, wd = x.shape
    o, _, k, _ = w.shape
    if stride <= 0 or pad < 0:
        raise ValueError(f"conv2d: stride {stride}, pad {pad}")
    oh = (h + 2 * pad - k) // stride + 1
    ow = (wd + 2 * pad - k) // stride + 1
    if oh <= 0 or ow <= 0:
        raise ValueError(f"conv2d: window {k}/{stride}/{pad} on {h}x{wd}")
    if b is not None and tuple(b.shape) != (o,):
        raise ValueError(f"conv2d: bias {tuple(b.shape)} for O={o}")
    return bsz, c, h, wd, o, k, oh, ow


def launch(x, w, b=None, *, stride=1, pad=0, activation="none",
           splits: Optional[int] = None):
    """The kernel on CUDA tensors.  ``splits`` defaults to
    :func:`split_count`; tests and the chip smoke pass it to hold the
    split and unsplit forms against the plain version."""
    bsz, c, h, wd, o, k, oh, ow = _shape(x, w, b, stride, pad, activation)
    operands = (x, w) if b is None else (x, w, b)
    dev = check_cuda_f32("conv2d", *operands)
    if not all(t.is_contiguous() for t in operands):
        raise ValueError("conv2d: x, w and bias must be contiguous")
    p, depth = bsz * oh * ow, c * k * k
    if max(x.numel(), o * p) > _INT_MAX:
        raise ValueError("conv2d: sizes must fit int32")
    if splits is None:
        splits = split_count(o, p, depth, sm_count(dev))
    if not 1 <= splits <= MAX_SPLITS \
            or -(-depth // SLAB) > splits * (MAX_SPAN // SLAB):
        raise ValueError(f"conv2d: depth {depth} in {splits} splits (1 to "
                         f"{MAX_SPLITS}, at most {MAX_SPAN} each)")
    out = x.new_empty((bsz, o, oh, ow))
    ws = x.new_empty((splits, o, p)) if splits > 1 else None
    if p and o:
        KERNEL.launch(dev, x.data_ptr(), w.data_ptr(),
                      None if b is None else b.data_ptr(), out.data_ptr(),
                      None if ws is None else ws.data_ptr(), bsz, c, h, wd, o,
                      k, stride, pad, ACT_CODES[activation], splits)
    return out
