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


def im2col(x, kernel: int, stride: int, pad: int):
    """x: (B, C, H, W) -> ((B*OH*OW, C*K*K) patch matrix, (B, OH, OW)),
    columns ordered (c, kh, kw) as in the JAX package."""
    b, c, h, w = x.shape
    oh = (h + 2 * pad - kernel) // stride + 1
    ow = (w + 2 * pad - kernel) // stride + 1
    if kernel == 1 and stride == 1 and pad == 0:
        return x.permute(0, 2, 3, 1).reshape(b * oh * ow, c), (b, oh, ow)
    cols = F.unfold(x, kernel, padding=pad, stride=stride)   # (B, C*K*K, L)
    return cols.transpose(1, 2).reshape(b * oh * ow, -1), (b, oh, ow)


def conv2d_im2col_ref(x, w, b=None, *, stride: int = 1, pad: int = 0,
                      activation: str = "none"):
    """B2's plain version: the patch matrix in the kernel's depth order
    (c, kh, kw) times the (C*K*K, O) weight matrix, + bias, then the
    activation, stored back as contiguous (B, O, OH, OW)."""
    o, c, k, _ = w.shape
    cols, (bsz, oh, ow) = im2col(x, k, stride, pad)
    out = matmul_ref(cols, w.reshape(o, c * k * k).t(), b,
                     activation=activation)
    return out.reshape(bsz, oh, ow, o).permute(0, 3, 1, 2).contiguous()


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


# ---------------------------------------------------------------------------
# B8 / B9: full-sequence flash attention, its forward with logsumexp and
# the FlashAttention-2 backward pieces
# ---------------------------------------------------------------------------


def flash_attention_ref(q, k, v, *, causal=True, window=0):
    """q: (B, S, H, D); k, v: (B, S, KV, D): full-sequence attention with
    the score matrix materialized (the model's ``attention_full``)."""
    from repro_torch.models.common import attention_full
    return attention_full(q, k, v, causal=causal, window=window)


def _repeat_heads(x, groups):
    """(B, S, KV, D) -> (B, S, KV*groups, D), query head h on KV head
    h // groups."""
    return x.repeat_interleave(groups, dim=2)


def _flash_probs(q, k, lse, causal, window):
    """Scaled, masked fp32 scores (B, H, Sq, Sk) of q against k, and with
    ``lse`` (B, H, Sq) the probabilities exp(s - lse) (0 where masked)."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    kr = _repeat_heads(k, h // k.shape[2])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr.float()) * (
        1.0 / math.sqrt(d))
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    s = torch.where(mask, s, -1e30)
    if lse is None:
        return s
    return torch.exp(s - lse[..., None])


def flash_fwd_lse_ref(q, k, v, *, causal=True, window=0):
    """(o in q's dtype (B, S, H, D), lse fp32 (B, H, S)): the forward of
    B9, with lse = m + log(max(l, 1e-30)) so that exp(s - lse) in the
    backward are the forward's probabilities."""
    s = _flash_probs(q, k, None, causal, window)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = torch.clamp_min(p.sum(dim=-1), 1e-30)
    vr = _repeat_heads(v, q.shape[2] // v.shape[2]).float()
    o = torch.einsum("bhqk,bkhd->bqhd", p, vr) / l.transpose(1, 2)[..., None]
    return o.to(q.dtype), m + torch.log(l)


def _flash_ds(q, k, v, do, lse, dsum, causal, window):
    """p and ds = p * (dO v^T - dsum) * scale, (B, H, Sq, Sk);
    dsum = rowsum(dO * o) (B, H, Sq)."""
    p = _flash_probs(q, k, lse, causal, window)
    vr = _repeat_heads(v, q.shape[2] // v.shape[2]).float()
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), vr)
    return p, p * (dp - dsum[..., None]) * (1.0 / math.sqrt(q.shape[-1]))


def flash_dq_ref(q, k, v, do, lse, dsum, *, causal=True, window=0):
    """dq (B, S, H, D) in q's dtype: ds k, summed over the keys."""
    _, ds = _flash_ds(q, k, v, do, lse, dsum, causal, window)
    kr = _repeat_heads(k, q.shape[2] // k.shape[2]).float()
    return torch.einsum("bhqk,bkhd->bqhd", ds, kr).to(q.dtype)


def flash_dkv_ref(q, k, v, do, lse, dsum, *, causal=True, window=0):
    """(dk, dv) (B, S, KV, D) in k's and v's dtypes: p^T dO and ds^T q
    per query head, then summed over each KV head's group of G."""
    p, ds = _flash_ds(q, k, v, do, lse, dsum, causal, window)
    b, sk, kvh, d = k.shape
    g = q.shape[2] // kvh
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    dk = dk.reshape(b, sk, kvh, g, d).sum(3)
    dv = dv.reshape(b, sk, kvh, g, d).sum(3)
    return dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# B10: the chunked RWKV-6 WKV
# ---------------------------------------------------------------------------


def rwkv6_chunked_ref(r, k, v, w, u):
    """B10's plain version: the model's chunked scan (16-token chunks,
    exponents clipped to [-60, 0]) from a zero state; (out, state)."""
    from repro_torch.models.rwkv6 import wkv_chunked
    return wkv_chunked(r, k, v, w, u)


def rwkv6_ref(r, k, v, w, u, s0=None):
    """Token-by-token RWKV6 recurrence (B, T, H, N): the oracle of both."""
    from repro_torch.models.rwkv6 import wkv_scan
    return wkv_scan(r, k, v, w, u, s0=s0)


def int8_matmul_ref(a_q, b_q, a_scale, b_scale):
    """a_q (M, K) int8 @ b_q (K, N) int8, summed exactly, then
    ``float(acc) * a_scale[:, None] * b_scale[None, :]`` in fp32.  On the
    CPU the sum is an int32 product; on the card, which has no int32
    matmul, an fp64 product of the integer values, exact while
    127^2 * K < 2^53, whose conversion to fp32 rounds as int32 -> fp32
    does.  Both wrap no earlier than int32 does (K >= 133,145)."""
    if a_q.device.type == "cpu":
        acc = a_q.to(torch.int32) @ b_q.to(torch.int32)
    else:
        acc = a_q.double() @ b_q.double()
    return acc.float() * a_scale.float()[:, None] * b_scale.float()[None, :]
