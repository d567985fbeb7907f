"""Shared model components for serving: param templates, norms, RoPE,
attention, and the KV-cache writes.

The port of the serving half of ``repro.models.common``.  Parameters are
nested dicts of tensors whose structure is described once by a template
tree of ``P`` leaves, as in the JAX package, so the store format and
``convert.params_from_numpy`` stay one-to-one with it.

Two parity hazards live here.  ``rms_norm`` scales by ``(1 + weight)``
(the norm weights start at zero), which ``torch.nn.RMSNorm`` does not.
RoPE rotates split halves (llama's rotate-half), not interleaved pairs.

Where the JAX code rebuilds an array (``.at[...].set``), the cache
writes here update the cache tensors in place and return them.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch.core.quantize import quantize_into

# ---------------------------------------------------------------------------
# Param templates
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class P:
    """Template for one parameter tensor: shape, logical axis names (kept
    for the JAX package's sharding vocabulary) and the initializer."""
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"          # normal | zeros | ones | embed
    scale: Optional[float] = None

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")

    @property
    def std(self) -> float:
        """The normal initializer's scale: ``scale``, else 0.02 for
        embeddings and 1/sqrt(fan_in) otherwise, fan-in being the
        contraction dim (second-to-last of a (possibly layer-stacked)
        matrix)."""
        if self.scale is not None:
            return self.scale
        if self.init == "embed":
            return 0.02
        fan_in = self.shape[-2] if len(self.shape) > 1 else max(self.shape[-1], 1)
        return 1.0 / math.sqrt(fan_in)


def map_template(fn, template):
    """Apply ``fn(P)`` to every leaf of a template tree."""
    if isinstance(template, dict):
        return {k: map_template(fn, v) for k, v in template.items()}
    return fn(template)


def init_params(template, generator: torch.Generator,
                dtype=torch.float32, device="cpu"):
    """Materialize a template tree with draws from ``generator`` (same
    scales as the JAX package; the draws themselves differ)."""
    def leaf(p: P):
        if p.init == "zeros":
            return torch.zeros(p.shape, dtype=dtype, device=device)
        if p.init == "ones":
            return torch.ones(p.shape, dtype=dtype, device=device)
        x = torch.randn(p.shape, generator=generator, dtype=torch.float32)
        return (p.std * x).to(dtype=dtype, device=device)
    return map_template(leaf, template)


def param_count_of(template) -> int:
    total = 0

    def leaf(p: P):
        nonlocal total
        total += math.prod(p.shape)
    map_template(leaf, template)
    return total


# ---------------------------------------------------------------------------
# Normalization + activations
# ---------------------------------------------------------------------------


def rms_norm(x, weight, eps=1e-6):
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + weight.float())).to(dtype)


def swiglu(x, w_gate, w_up, w_down):
    g = x @ w_gate
    u = x @ w_up
    return (torch.nn.functional.silu(g) * u) @ w_down


# ---------------------------------------------------------------------------
# Rotary position embeddings (llama-style rotate-half)
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)           # (head_dim/2,)


def apply_rope(x, positions, theta: float):
    """x: (..., S, n_heads, head_dim); positions: (..., S) integer."""
    head_dim = x.shape[-1]
    freqs = rope_freqs(head_dim, theta, device=x.device)
    angles = positions[..., None].float() * freqs   # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]           # broadcast over heads
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention: chunked (flash-style) for prefill, plus the decode path
# ---------------------------------------------------------------------------

NEG_INF = -1e30


def _repeat_kv(x, groups: int):
    """(B, S, KV, D) -> (B, S, KV*groups, D)"""
    b, s, kv, d = x.shape
    return x[:, :, :, None, :].expand(b, s, kv, groups, d).reshape(
        b, s, kv * groups, d)


def _mask(sq, sk, q_offset, causal, window, device):
    qpos = torch.arange(sq, device=device) + q_offset
    kpos = torch.arange(sk, device=device)
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window:
        mask &= kpos[None, :] > (qpos[:, None] - window)
    return mask


def attention_full(q, k, v, *, causal: bool = True, window: int = 0,
                   q_offset: int = 0):
    """Naive reference attention (materializes scores).
    q: (B, Sq, H, D); k, v: (B, Sk, KV, D)."""
    b, sq, h, d = q.shape
    kvh = k.shape[2]
    k = _repeat_kv(k, h // kvh)
    v = _repeat_kv(v, h // kvh)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(d)
    mask = _mask(sq, k.shape[1], q_offset, causal, window, q.device)
    scores = torch.where(mask[None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


def attention_chunked(q, k, v, *, causal: bool = True, window: int = 0,
                      q_chunk: int = 1024, k_chunk: int = 1024,
                      q_offset: int = 0):
    """Flash-style attention in tensor ops: online softmax over KV
    chunks, (B, H, q_chunk, k_chunk) scores per step.  The JAX package's
    schedule (``lax.map`` over q chunks, ``lax.scan`` over k chunks)
    becomes two Python loops; shapes that do not divide into chunks take
    :func:`attention_full`, as there."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    kvh = k.shape[2]
    groups = h // kvh
    q_chunk = min(q_chunk, sq)
    k_chunk = min(k_chunk, sk)
    if sq % q_chunk or sk % k_chunk:
        return attention_full(q, k, v, causal=causal, window=window,
                              q_offset=q_offset)
    scale = 1.0 / math.sqrt(d)
    outs = []
    for qi in range(sq // q_chunk):
        qc = q[:, qi * q_chunk:(qi + 1) * q_chunk]
        m = torch.full((b, h, q_chunk), NEG_INF, device=q.device)
        l = torch.zeros((b, h, q_chunk), device=q.device)
        acc = torch.zeros((b, h, q_chunk, d), device=q.device)
        for ki in range(sk // k_chunk):
            kc = _repeat_kv(k[:, ki * k_chunk:(ki + 1) * k_chunk], groups)
            vc = _repeat_kv(v[:, ki * k_chunk:(ki + 1) * k_chunk], groups)
            s = torch.einsum("bqhd,bkhd->bhqk", qc.float(), kc.float()) * scale
            mask = _mask(q_chunk, k_chunk, qi * q_chunk + q_offset - ki * k_chunk,
                         causal, window, q.device)
            s = torch.where(mask[None, None], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p,
                                                       vc.float())
            m = m_new
        out = acc / torch.clamp_min(l[..., None], 1e-30)
        outs.append(out.permute(0, 2, 1, 3))            # bhqd -> bqhd
    return torch.cat(outs, dim=1).to(q.dtype)


def attention_decode(q, k_cache, v_cache, valid_len, layout="bskd"):
    """One-token decode attention against a (possibly ring) KV cache: the
    registry's ``ref`` backend.

    q: (B, 1, H, D); caches: (B, S, KV, D) ('bskd') or (B, KV, S, D)
    ('bksd'); valid_len: a scalar or a per-lane (B,) vector.  As in the
    JAX package, q and the probabilities are cast to the cache dtype
    before the products, which accumulate in fp32: with a bf16 cache this
    differs from the kernel, which keeps q and p in fp32.
    """
    b, _, h, d = q.shape
    if layout == "bskd":
        s, kvh = k_cache.shape[1], k_cache.shape[2]
        eq_s, eq_o = "bkgd,bskd->bkgs", "bkgs,bskd->bkgd"
    elif layout == "bksd":
        kvh, s = k_cache.shape[1], k_cache.shape[2]
        eq_s, eq_o = "bkgd,bksd->bkgs", "bkgs,bksd->bkgd"
    else:
        raise ValueError(f"unknown layout {layout!r}")
    groups = h // kvh
    cdt = k_cache.dtype
    qg = q[:, 0].reshape(b, kvh, groups, d)
    scores = torch.einsum(eq_s, qg.to(cdt).float(), k_cache.float()) / math.sqrt(d)
    valid_len = torch.as_tensor(valid_len, device=q.device)
    slots = torch.arange(s, device=q.device)
    if valid_len.ndim == 0:
        valid = (slots < valid_len)[None, None, None, :]
    else:                       # ragged: per-lane (B,) valid prefix
        valid = (slots[None, :] < valid_len[:, None])[:, None, None]
    scores = torch.where(valid, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum(eq_o, probs.to(cdt).float(), v_cache.float())
    return out.reshape(b, 1, h, d).to(q.dtype)


# ---------------------------------------------------------------------------
# KV cache writes (ring buffer when the cache is shorter than the stream)
# ---------------------------------------------------------------------------


def as_device_scalar(x, device) -> torch.Tensor:
    """An int or a tensor as a tensor on ``device``, without a blocking
    host-to-device copy (``torch.full`` fills on the device)."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.full((), x, device=device)


def cache_write(cache_k, cache_v, k_new, v_new, pos, seq_axis: int = 1):
    """Write one token at ring position pos % S along ``seq_axis``, in
    place.  ``pos`` is an int or a 0-dim device tensor (no host read)."""
    s = cache_k.shape[seq_axis]
    idx = torch.remainder(as_device_scalar(pos, cache_k.device), s)
    idx = idx.reshape(1).long()
    cache_k.index_copy_(seq_axis, idx, k_new.to(cache_k.dtype))
    cache_v.index_copy_(seq_axis, idx, v_new.to(cache_v.dtype))
    return cache_k, cache_v


def cache_write_batch(cache_k, cache_v, k_new, v_new, pos, seq_axis: int = 2):
    """Per-lane ring write for the lane-major batched decode step, in
    place: lane b's token lands at ring slot ``pos[b] % S``.  ``k_new`` /
    ``v_new``: (B, KV, 1, D) for bksd caches (``seq_axis=2``) or
    (B, 1, KV, D) for bskd (``seq_axis=1``)."""
    s = cache_k.shape[seq_axis]
    idx = torch.remainder(pos, s).long()
    rows = torch.arange(cache_k.shape[0], device=cache_k.device)
    if seq_axis == 2:
        cache_k[rows, :, idx] = k_new[:, :, 0].to(cache_k.dtype)
        cache_v[rows, :, idx] = v_new[:, :, 0].to(cache_v.dtype)
    elif seq_axis == 1:
        cache_k[rows, idx] = k_new[:, 0].to(cache_k.dtype)
        cache_v[rows, idx] = v_new[:, 0].to(cache_v.dtype)
    else:
        raise ValueError(f"seq_axis must be 1 or 2, got {seq_axis}")
    return cache_k, cache_v


def _quantized_rows(k_new, v_new, seq_axis):
    if seq_axis == 2:
        k_rows, v_rows = k_new[:, :, 0], v_new[:, :, 0]
    elif seq_axis == 1:
        k_rows, v_rows = k_new[:, 0], v_new[:, 0]
    else:
        raise ValueError(f"seq_axis must be 1 or 2, got {seq_axis}")
    return quantize_into(k_rows, axis=-1) + quantize_into(v_rows, axis=-1)


def cache_write_batch_q8(cache_k, cache_v, scale_k, scale_v, k_new, v_new,
                         pos, seq_axis: int = 2):
    """Quantizing per-lane ring write for the int8 KV cache, in place: the
    token's K/V rows are quantized per (lane, kv-head) over head_dim, and
    payload and scale land at ring slot ``pos[b] % S``.  Caches int8
    (B, KV, S, D) / (B, S, KV, D); scales fp32 (B, KV, S) / (B, S, KV)."""
    s = cache_k.shape[seq_axis]
    idx = torch.remainder(pos, s).long()
    rows = torch.arange(cache_k.shape[0], device=cache_k.device)
    kq, ks, vq, vs = _quantized_rows(k_new, v_new, seq_axis)
    if seq_axis == 2:
        cache_k[rows, :, idx] = kq
        cache_v[rows, :, idx] = vq
        scale_k[rows, :, idx] = ks
        scale_v[rows, :, idx] = vs
    else:
        cache_k[rows, idx] = kq
        cache_v[rows, idx] = vq
        scale_k[rows, idx] = ks
        scale_v[rows, idx] = vs
    return cache_k, cache_v, scale_k, scale_v


def cache_valid_len(pos, cache_size):
    return torch.clamp_max(pos + 1, cache_size)


def _paged_slot(page_table, pos, page_size):
    """Per-lane write coordinates in a page pool: ``pos`` wraps at the
    lane's logical capacity ``W * page_size`` (as the ring's ``pos % S``)
    and splits into (pool page via the lane's table row, page offset)."""
    w = page_table.shape[1]
    p = torch.remainder(pos, w * page_size).long()
    rows = torch.arange(page_table.shape[0], device=page_table.device)
    phys = page_table[rows, p // page_size].long()      # (B,) pool pages
    return phys, p % page_size


def cache_write_batch_paged(pool_k, pool_v, page_table, k_new, v_new, pos,
                            seq_axis: int = 2):
    """Per-lane one-token write into a paged KV pool, in place.  Pools
    (P, KV, ps, D) for ``seq_axis=2`` or (P, ps, KV, D) for 1;
    ``page_table`` (B, W) int32.  Inactive lanes' zeroed table rows land
    in the reserved garbage page 0."""
    ps = pool_k.shape[seq_axis]
    phys, off = _paged_slot(page_table, pos, ps)
    if seq_axis == 2:
        pool_k[phys, :, off] = k_new[:, :, 0].to(pool_k.dtype)
        pool_v[phys, :, off] = v_new[:, :, 0].to(pool_v.dtype)
    elif seq_axis == 1:
        pool_k[phys, off] = k_new[:, 0].to(pool_k.dtype)
        pool_v[phys, off] = v_new[:, 0].to(pool_v.dtype)
    else:
        raise ValueError(f"seq_axis must be 1 or 2, got {seq_axis}")
    return pool_k, pool_v


def cache_write_batch_paged_q8(pool_k, pool_v, scale_k, scale_v, page_table,
                               k_new, v_new, pos, seq_axis: int = 2):
    """Quantizing paged write: int8 payload pools plus per-slot fp32
    scale pools (P, KV, ps) / (P, ps, KV), in place."""
    ps = pool_k.shape[seq_axis]
    phys, off = _paged_slot(page_table, pos, ps)
    kq, ks, vq, vs = _quantized_rows(k_new, v_new, seq_axis)
    if seq_axis == 2:
        pool_k[phys, :, off] = kq
        pool_v[phys, :, off] = vq
        scale_k[phys, :, off] = ks
        scale_v[phys, :, off] = vs
    else:
        pool_k[phys, off] = kq
        pool_v[phys, off] = vq
        scale_k[phys, off] = ks
        scale_v[phys, off] = vs
    return pool_k, pool_v, scale_k, scale_v


def decode_attention_named(q, k_cache, v_cache, valid_len, *,
                           layout: str = "bksd",
                           backend: Optional[str] = None,
                           k_scale=None, v_scale=None, page_table=None):
    """Decode attention through the op registry's named backends: 'ref'
    (:func:`attention_decode`), 'cuda' (the flash-decode kernel), or
    None/'auto' (cuda on a CUDA tensor, ref on a CPU one).  Scales mark
    an int8 cache and a page table a paged pool; they resolve the q8 and
    paged twins of the same two names."""
    from repro_torch.core.ops import REGISTRY, resolve_decode_backend
    quantized = k_scale is not None
    paged = page_table is not None
    name = resolve_decode_backend(backend, quantized=quantized, paged=paged,
                                  device=q.device)
    fn = REGISTRY.op("decode_attention").backends[name]
    kw = {}
    if quantized:
        kw.update(k_scale=k_scale, v_scale=v_scale)
    if paged:
        kw.update(page_table=page_table)
    return fn(q, k_cache, v_cache, valid_len, layout=layout, **kw)
