"""B2: convolution as im2col + the B1 matrix product.

Replaces repro/kernels/conv2d.py ``conv2d``, which is not a Pallas kernel
of its own: the JAX package leaves the patch gather to XLA and runs the
product through the Pallas matmul.  Here the gather stays in tensor ops
(``F.unfold``, or a transpose for a 1x1 stride-1 conv) and the product,
with the bias fused, runs through the B1 kernel.  ``F.conv2d`` and cuDNN
are never on this path.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import matmul as _mm
from repro_torch.kernels._build import CompositeKernel
from repro_torch.kernels.matmul import matmul

KERNEL = CompositeKernel(_mm.KERNEL)


def im2col(x: torch.Tensor, kernel: int, stride: int, pad: int
           ) -> Tuple[torch.Tensor, Tuple[int, int, int]]:
    """x: (B, C, H, W) -> (B*OH*OW, C*K*K) patch matrix, columns ordered
    (c, kh, kw) as in the JAX package."""
    b, c, h, w = x.shape
    oh = (h + 2 * pad - kernel) // stride + 1
    ow = (w + 2 * pad - kernel) // stride + 1
    if kernel == 1 and stride == 1 and pad == 0:
        return x.permute(0, 2, 3, 1).reshape(b * oh * ow, c), (b, oh, ow)
    cols = F.unfold(x, kernel, padding=pad, stride=stride)   # (B, C*K*K, L)
    return cols.transpose(1, 2).reshape(b * oh * ow, -1), (b, oh, ow)


def conv2d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
           *, stride: int = 1, pad: int = 0, activation: str = "none"
           ) -> torch.Tensor:
    """x: (B, C, H, W); w: (O, C, K, K) -> contiguous (B, O, OH, OW)."""
    o, c, k, _ = w.shape
    cols, (bsz, oh, ow) = im2col(x, k, stride, pad)
    wmat = w.reshape(o, c * k * k).t()        # (C*K*K, O) view, read by strides
    out = matmul(cols, wmat, b, activation=activation)
    if x.device.type != "cpu":
        KERNEL.launches += 1                  # the B1 launch just made
    return out.reshape(bsz, oh, ow, o).permute(0, 3, 1, 2).contiguous()
