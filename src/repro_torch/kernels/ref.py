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


# ---------------------------------------------------------------------------
# B6 / B7: ragged flash-decode against ring and paged KV caches
# ---------------------------------------------------------------------------


def _valid_mask(valid_len, s, device):
    valid = torch.as_tensor(valid_len, device=device)
    slots = torch.arange(s, device=device)
    if valid.ndim == 0:
        return (slots < valid)[None, None, None]
    return (slots[None, :] < valid[:, None])[:, None, None]


def decode_attention_ref(q, k, v, valid_len, *, layout="bskd"):
    """q: (B, H, D); k, v: (B, S, KV, D) ('bskd') or (B, KV, S, D)
    ('bksd'); valid_len: scalar or per-lane (B,).  fp32 throughout."""
    b, h, d = q.shape
    if layout == "bksd":
        k = k.transpose(1, 2)
        v = v.transpose(1, 2)
    s, kvh = k.shape[1], k.shape[2]
    qg = q.reshape(b, kvh, h // kvh, d)
    scores = torch.einsum("bkgd,bskd->bkgs", qg.float(), k.float()) / math.sqrt(d)
    scores = torch.where(_valid_mask(valid_len, s, q.device), scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", probs, v.float())
    return out.reshape(b, h, d).to(q.dtype)


def decode_attention_q8_ref(q, k_q, v_q, k_scale, v_scale, valid_len, *,
                            layout="bskd"):
    """Ragged int8 decode: payloads int8, one fp32 scale per (lane,
    kv-head, slot), scales (B, S, KV) ('bskd') or (B, KV, S) ('bksd').
    K scales multiply the score columns after the QK dot and V scales the
    probabilities before the PV dot, in the kernel's order."""
    b, h, d = q.shape
    if layout == "bksd":
        k_q = k_q.transpose(1, 2)
        v_q = v_q.transpose(1, 2)
        k_scale = k_scale.transpose(1, 2)          # -> (B, S, KV)
        v_scale = v_scale.transpose(1, 2)
    s, kvh = k_q.shape[1], k_q.shape[2]
    qg = q.reshape(b, kvh, h // kvh, d)
    scores = torch.einsum("bkgd,bskd->bkgs", qg.float(), k_q.float()) / math.sqrt(d)
    scores = scores * k_scale.float().transpose(1, 2)[:, :, None]
    scores = torch.where(_valid_mask(valid_len, s, q.device), scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    probs = probs * v_scale.float().transpose(1, 2)[:, :, None]
    out = torch.einsum("bkgs,bskd->bkgd", probs, v_q.float())
    return out.reshape(b, h, d).to(q.dtype)


def paged_gather(pool, page_table, *, layout="bksd"):
    """The ring-equivalent lane-major cache out of a page pool: lane b's
    logical slot t is ``pool[page_table[b, t // ps]][..., t % ps, ...]``.
    pool: (P, KV, ps, D) ('bksd') or (P, ps, KV, D) ('bskd'), or the scale
    pools (P, KV, ps) / (P, ps, KV); page_table: (B, W)."""
    g = pool[page_table.long()]                 # (B, W, *page_shape)
    b, w = g.shape[:2]
    if layout == "bskd":                        # page (ps, KV[, D])
        return g.reshape(b, w * g.shape[2], *g.shape[3:])
    if layout != "bksd":
        raise ValueError(f"unknown layout {layout!r}")
    g = g.movedim(1, 2)                         # (B, KV, W, ps[, D])
    return g.reshape(b, g.shape[1], w * g.shape[3], *g.shape[4:])


def decode_attention_paged_ref(q, k_pool, v_pool, page_table, valid_len, *,
                               layout="bksd"):
    """Paged decode: gather pages into the ring layout, then the ring
    version.  valid_len counts logical slots (<= W * ps)."""
    k = paged_gather(k_pool, page_table, layout=layout)
    v = paged_gather(v_pool, page_table, layout=layout)
    return decode_attention_ref(q, k, v, valid_len, layout=layout)


def decode_attention_paged_q8_ref(q, k_pool, v_pool, k_scale, v_scale,
                                  page_table, valid_len, *, layout="bksd"):
    """Paged int8 decode: gather payload and scale pools, then the q8
    ring version."""
    k = paged_gather(k_pool, page_table, layout=layout)
    v = paged_gather(v_pool, page_table, layout=layout)
    ks = paged_gather(k_scale, page_table, layout=layout)
    vs = paged_gather(v_scale, page_table, layout=layout)
    return decode_attention_q8_ref(q, k, v, ks, vs, valid_len, layout=layout)
