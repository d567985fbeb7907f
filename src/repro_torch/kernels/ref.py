"""Plain PyTorch versions of every kernel (the correctness ground truth).

Each ``*_ref`` computes the same function as the kernel wrapper of the
same name, in fp32, with tensor ops only.  The CPU path of each wrapper is
its plain version; on the card, ``chip_smoke.py`` holds each kernel
against it.  They repeat the kernel's arithmetic and are no yardstick of
speed.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

_GELU_K = math.sqrt(2.0 / math.pi)

ACTS = {
    "relu": lambda x: torch.where(x < 0, torch.zeros_like(x), x),
    "silu": lambda x: x * torch.sigmoid(x),
    # tanh approximation: jax.nn.gelu's default (torch's F.gelu is erf)
    "gelu": lambda x: x * (0.5 * (1.0 + torch.tanh(
        _GELU_K * (x + 0.044715 * (x * x * x))))),
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
}


def apply_activation(x, activation: str):
    if activation == "none":
        return x
    return ACTS[activation](x)


def matmul_ref(a, b, bias=None, *, activation: str = "none"):
    """(M, K) @ (K, N) in fp32, + bias (N,), then the activation."""
    out = a.float() @ b.float()
    if bias is not None:
        out = out + bias.float()
    return apply_activation(out, activation).to(a.dtype)


def conv2d_ref(x, w, b=None, *, stride: int = 1, pad: int = 0):
    """x: (B, C, H, W); w: (O, C, K, K)."""
    return F.conv2d(x, w, b, stride=stride, padding=pad)


def _windows(x, kernel: int, stride: int, oh: int, ow: int):
    """The K*K shifted strided views of padded planes, row-major order."""
    for di in range(kernel):
        for dj in range(kernel):
            yield x[..., di:di + (oh - 1) * stride + 1:stride,
                    dj:dj + (ow - 1) * stride + 1:stride]


def pool2d_ref(x, *, mode: str = "max", kernel: int = 2, stride: int = 2,
               pad: int = 0):
    """K x K stride-s pooling of (B, C, H, W).  Max pads with -inf; avg
    divides by the count of in-bounds taps (Caffe semantics).  Sums in the
    window's row-major order, as the kernel does."""
    if mode not in ("max", "avg"):
        raise ValueError(f"unknown pool mode {mode!r}")
    h, w = x.shape[-2:]
    oh = (h + 2 * pad - kernel) // stride + 1
    ow = (w + 2 * pad - kernel) // stride + 1
    fill = -math.inf if mode == "max" else 0.0
    xp = F.pad(x, (pad, pad, pad, pad), value=fill) if pad else x
    acc = None
    for v in _windows(xp, kernel, stride, oh, ow):
        if acc is None:
            acc = v.clone()
        elif mode == "max":
            acc = torch.maximum(acc, v)
        else:
            acc = acc + v
    if mode == "max":
        return acc
    ones = torch.ones((1, 1, h, w), dtype=x.dtype, device=x.device)
    ones = F.pad(ones, (pad, pad, pad, pad)) if pad else ones
    count = sum(_windows(ones, kernel, stride, oh, ow))
    return acc / count


def elementwise_ref(x, act: str = "relu"):
    return ACTS[act](x.float()).to(x.dtype)


def softmax_ref(x):
    """Stable fp32 softmax over the last axis of (R, N)."""
    xf = x.float()
    e = torch.exp(xf - xf.amax(dim=-1, keepdim=True))
    return (e / e.sum(dim=-1, keepdim=True)).to(x.dtype)
