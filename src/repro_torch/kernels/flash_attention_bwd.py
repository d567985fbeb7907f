"""B9: differentiable flash attention, the forward and the fused
FlashAttention-2 backward on the kernels of ``kernels/flash_attention.py``.

The port of repro/kernels/flash_attention_bwd.py's custom VJP as a
``torch.autograd.Function``.  The forward saves only q, k, v, o and the
per-row logsumexp; the backward computes ``dsum = rowsum(dO * o)`` in
torch, as the reference does outside its kernels, then launches the dq
kernel and the dk/dv kernel, which recompute p = exp(s - lse) tile by
tile.  On CPU tensors the same steps run the plain versions of
``kernels/ref.py``, so the recompute arithmetic itself is held against
the JAX package's gradients.

The memory count (``launch.memory``) replays :meth:`FlashAttention.forward`'s
wrapper and :func:`backward_kernels` on meta tensors: the forward keeps
q, k, v, o and lse (B, H, Sq) fp32 until the backward; the backward
allocates dsum (B, H, Sq) fp32 (and the product it sums), dq, dk and dv.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa


class FlashAttention(torch.autograd.Function):
    """q (B, S, H, D), k, v (B, S, KV, D) -> o (B, S, H, D)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        o, lse = _fa.flash_fwd_lse(q, k, v, causal=causal, window=window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        dq, dk, dv = backward_kernels(*ctx.saved_tensors, do,
                                      causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None


def backward_kernels(q, k, v, o, lse, do, *, causal: bool, window: int):
    """B9's backward from the saved tensors and dO: (dq, dk, dv)."""
    do = do.to(q.dtype)
    kw = dict(causal=causal, window=window)
    dsum = _fa.dsum_of(o, do)
    dq = _fa.flash_dq(q, k, v, do, lse, dsum, **kw)
    dk, dv = _fa.flash_dkv(q, k, v, do, lse, dsum, **kw)
    return dq, dk, dv


def flash_attention_trainable(q, k, v, causal: bool = True, window: int = 0):
    """Differentiable flash attention: B9's forward, and its dq and dk/dv
    kernels in the backward."""
    return FlashAttention.apply(q, k, v, causal, window)
