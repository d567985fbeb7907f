"""FFT-based convolution — DeepLearningKit roadmap item 1.

The port of ``repro.core.fftconv``.  Convolution in the spatial domain is
a pointwise product in the frequency domain; for large feature maps or
large kernels the O(HW log HW) transform beats the O(HW K^2) direct form.
The paper's roadmap pairs this with storing *precalculated* filter FFTs:
``precompute_filters`` does that, so serving pays only the input
transform per call.

The JAX package runs this outside Pallas (there is no FFT primitive
there); here it is ``torch.fft`` (``rfft2`` / ``irfft2`` in complex64 for
fp32 inputs), with the reference's flip, crop and stride semantics.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def _fft_shape(h: int, w: int, k: int) -> Tuple[int, int]:
    """Linear convolution needs H + K - 1 points; rounded up to the next
    power of two for FFT efficiency."""
    def np2(n):
        p = 1
        while p < n:
            p *= 2
        return p
    return np2(h + k - 1), np2(w + k - 1)


def precompute_filters(w: torch.Tensor, out_hw: Tuple[int, int]):
    """w: (O, C, K, K) -> rfft2 of the *flipped* kernel, padded to out_hw.

    Cross-correlation (what conv layers compute) equals convolution with
    a spatially flipped kernel, so the flip happens here once, at
    model-publish time.
    """
    return torch.fft.rfft2(torch.flip(w, dims=(-2, -1)), s=out_hw)


def fft_conv2d(x: torch.Tensor, w: torch.Tensor,
               b: Optional[torch.Tensor] = None, *, stride: int = 1,
               pad: int = 0, w_fft: Optional[torch.Tensor] = None):
    """FFT convolution with ``conv2d_ref``'s semantics.

    x: (B, C, H, W); w: (O, C, K, K).  Pass ``w_fft`` (from
    :func:`precompute_filters`) to skip the filter transform.
    """
    _, _, h, wd = x.shape
    k = w.shape[-1]
    if pad:
        x = torch.nn.functional.pad(x, (pad, pad, pad, pad))
        h, wd = h + 2 * pad, wd + 2 * pad
    fh, fw = _fft_shape(h, wd, k)
    if w_fft is None:
        w_fft = precompute_filters(w, (fh, fw))
    x_fft = torch.fft.rfft2(x, s=(fh, fw))                  # (B, C, fh, fw')
    prod = torch.einsum("bchw,ochw->bohw", x_fft, w_fft)
    full = torch.fft.irfft2(prod, s=(fh, fw))              # linear conv
    # the 'valid' part of the linear convolution = the cross-correlation
    oh, ow = h - k + 1, wd - k + 1
    out = full[:, :, k - 1:k - 1 + oh, k - 1:k - 1 + ow]
    if stride > 1:
        out = out[:, :, ::stride, ::stride]
    if b is not None:
        out = out + b[None, :, None, None]
    return out.to(x.dtype)


def fft_conv_flops(h: int, w: int, c: int, o: int, k: int) -> int:
    """Analytic FLOP estimate (the crossover analysis of the benchmarks):
    input FFTs, output inverse FFTs and the pointwise complex products."""
    fh, fw = _fft_shape(h, w, k)
    fft_pts = fh * fw
    logf = math.log2(fft_pts)
    return int(5 * fft_pts * logf * (c + o) + 8 * fft_pts * c * o)
