"""Shared model components: param templates, norms, RoPE, attention, the
KV-cache writes and the loss.

The port of the serving and training parts of ``repro.models.common``.
Parameters are nested dicts of tensors whose structure is described once
by a template tree of ``P`` leaves, as in the JAX package, so the store
format and ``convert.params_from_numpy`` stay one-to-one with it.

Three parity hazards live here.  ``rms_norm`` scales by ``(1 + weight)``
(the norm weights start at zero), which ``torch.nn.RMSNorm`` does not.
RoPE rotates split halves (llama's rotate-half), not interleaved pairs.
``gelu`` is the tanh form, ``jax.nn.gelu``'s default, not torch's erf.

Where the JAX code rebuilds an array (``.at[...].set``), the cache
writes here update the cache tensors in place and return them.

Under a mesh (``launch.sharding``) parameters and activations are
DTensors: ``hint`` redistributes them at the JAX package's sites, and
full-sequence attention runs on each rank's local shards through
``compat.shard_map`` (:func:`flash_attention_named`), since the kernels
take plain tensors.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.quantize import quantize_into
from repro_torch.sharding_hints import hint, is_dtensor, zeros

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
        x = torch.randn(p.shape, generator=generator, dtype=torch.float32,
                        device=generator.device)
        return (p.std * x).to(dtype=dtype, device=device)
    return map_template(leaf, template)


def param_struct(template, dtype=torch.bfloat16):
    """Meta tensors (shape and dtype, no storage) for every leaf: the
    twin of the JAX package's ``ShapeDtypeStruct`` tree."""
    return map_template(
        lambda p: torch.empty(p.shape, dtype=dtype, device="meta"), template)


def param_axes(template):
    """Tree of logical-axis tuples, same structure as the params."""
    return map_template(lambda p: p.axes, template)


def meta_tree(tree):
    """A tree of ``(shape, dtype)`` leaves (the form of every family's
    ``cache_spec``) as meta tensors."""
    if isinstance(tree, dict):
        return {k: meta_tree(v) for k, v in tree.items()}
    shape, dtype = tree
    return torch.empty(shape, dtype=dtype, device="meta")


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


def layer_norm(x, weight, bias, eps=1e-5):
    """LayerNorm over the last axis in fp32 (biased variance), cast back
    to ``x``'s dtype."""
    dtype = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(dtype)


def swiglu(x, w_gate, w_up, w_down):
    g = hint(x @ w_gate, "batch", "seq", "ff")
    u = hint(x @ w_up, "batch", "seq", "ff")
    return hint((torch.nn.functional.silu(g) * u) @ w_down,
                "batch", "seq", "embed")


def gelu(x):
    """``jax.nn.gelu``'s default, the tanh form (torch's default is erf)."""
    return torch.nn.functional.gelu(x, approximate="tanh")


def gelu_mlp(x, w_in, b_in, w_out, b_out):
    return gelu(x @ w_in + b_in) @ w_out + b_out


def embed_lookup(table, tokens):
    """``table[tokens]``.  On DTensors a vocab-parallel lookup in a
    ``compat.shard_map`` body: the table's rows split on its
    ``tp_vocab`` axes (its ``fsdp`` split gathered), each rank gathers
    the tokens in its rows and zeros the rest, and the partial sums meet
    in the (batch, seq, embed) placement, so that no matmul after it runs
    at the global batch."""
    if not is_dtensor(table):
        return table[tokens]
    from torch.distributed.tensor import Partial

    from repro_torch.launch.compat import shard_map
    from repro_torch.sharding_hints import logical_to_spec, to_placements
    mesh = table.device_mesh
    vocab = table.shape[0]
    tspec = logical_to_spec(("tp_vocab", None), shape=table.shape)
    kspec = logical_to_spec(("batch",) + (None,) * (tokens.ndim - 1),
                            shape=tokens.shape)
    v_axes = _axes_of(tspec[0])
    v0, vl = _shard_offset(mesh, v_axes, vocab)
    out_pl = tuple(Partial() if n in v_axes else p for n, p in zip(
        mesh.mesh_dim_names, to_placements(kspec + (None,), mesh)))
    grad_pl = tuple(Partial() if n in _axes_of(kspec[0]) else p
                    for n, p in zip(mesh.mesh_dim_names,
                                    to_placements(tspec, mesh)))

    def body(rows, tok):
        if not v_axes:
            return rows[tok]
        local = tok - v0
        hit = (local >= 0) & (local < vl)
        x = rows[torch.where(hit, local, 0)]
        return torch.where(hit[..., None], x, 0.0)

    fn = shard_map(body, mesh=mesh, in_specs=(tspec, kspec),
                   out_specs=out_pl, in_grad_specs=(grad_pl, kspec))
    return hint(fn(table, tokens), *("batch", "seq")[:tokens.ndim], "embed")


def split_heads(x, n: int, name: str = "heads"):
    """(..., n * D) -> (..., n, D).  On a DTensor whose last dim is split
    at a finer grain than a head (64 kv columns over 4 ranks, 2 heads of
    32), the split first moves to whole heads (logical ``name``), or off
    that dim where the head count does not divide."""
    shape = tuple(x.shape[:-1]) + (n, x.shape[-1] // n)
    if is_dtensor(x):
        from repro_torch.sharding_hints import logical_to_spec, to_placements
        lead = ("batch", "seq")[:x.ndim - 1]
        lead = (None,) * (x.ndim - 1 - len(lead)) + lead
        spec = logical_to_spec(lead + (name, None), shape=shape)
        placements = to_placements(spec[:-1], x.device_mesh)
        if tuple(x.placements) != placements:
            x = x.redistribute(x.device_mesh, placements)
    return x.reshape(shape)


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


def _chunk_step(qc, kc, vc, m, l, acc, mask, scale, bf16_pv):
    """One k chunk of the online softmax: (m, l, acc) updated."""
    s = torch.einsum("bqhd,bkhd->bhqk", qc.float(), kc.float()) * scale
    s = torch.where(mask[None, None], s, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l = l * corr + p.sum(dim=-1)
    if bf16_pv:
        pv = torch.einsum("bhqk,bkhd->bhqd", p.to(torch.bfloat16),
                          vc.to(torch.bfloat16)).float()
    else:
        pv = torch.einsum("bhqk,bkhd->bhqd", p, vc.float())
    return m_new, l, acc * corr[..., None] + pv


def attention_chunked(q, k, v, *, causal: bool = True, window: int = 0,
                      q_chunk: int = 1024, k_chunk: int = 1024,
                      q_offset: int = 0, save_memory: bool = False):
    """Flash-style attention in tensor ops: online softmax over KV
    chunks, (B, H, q_chunk, k_chunk) scores per step.  The JAX package's
    schedule (``lax.map`` over q chunks, ``lax.scan`` over k chunks)
    becomes two Python loops; shapes that do not divide into chunks take
    :func:`attention_full`, as there.  ``save_memory`` (the ``attn_ckpt``
    perf rule) recomputes each k chunk's scores in the backward instead
    of keeping them, and takes p.v in bf16, as the JAX package's does.
    On meta tensors with no gradient (the dry run's prefill) two chunk
    steps run, counted for all, with the other q chunks' outputs held
    (``op_costs.trips``)."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    kvh = k.shape[2]
    groups = h // kvh
    q_chunk = min(q_chunk, sq)
    k_chunk = min(k_chunk, sk)
    if sq % q_chunk or sk % k_chunk:
        return attention_full(q, k, v, causal=causal, window=window,
                              q_offset=q_offset)
    from repro_torch.launch.op_costs import trips
    scale = 1.0 / math.sqrt(d)
    remat = save_memory and torch.is_grad_enabled()
    # two trips stand for all only where no backward replays the loop
    nq, nk = sq // q_chunk, sk // k_chunk
    meta = q.is_meta and not (torch.is_grad_enabled() and q.requires_grad)
    q_trips = trips(nq, meta)
    for qi in q_trips:
        qc = q[:, qi * q_chunk:(qi + 1) * q_chunk]
        m = torch.full((b, h, q_chunk), NEG_INF, device=q.device)
        l = torch.zeros((b, h, q_chunk), device=q.device)
        acc = torch.zeros((b, h, q_chunk, d), device=q.device)
        for ki in trips(nk, meta):
            kc = _repeat_kv(k[:, ki * k_chunk:(ki + 1) * k_chunk], groups)
            vc = _repeat_kv(v[:, ki * k_chunk:(ki + 1) * k_chunk], groups)
            mask = _mask(q_chunk, k_chunk, qi * q_chunk + q_offset - ki * k_chunk,
                         causal, window, q.device)
            args = (qc, kc, vc, m, l, acc, mask, scale, save_memory)
            m, l, acc = checkpoint(_chunk_step, *args, use_reentrant=False) \
                if remat else _chunk_step(*args)
        out = acc / torch.clamp_min(l[..., None], 1e-30)
        q_trips.keep(out.permute(0, 2, 1, 3))           # bhqd -> bqhd
    return torch.cat(q_trips.outs, dim=1).to(q.dtype)


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


def prefill_cache(init_cache, cache_spec, cfg, batch: int, cache_len: int,
                  dtype, x):
    """The cache a family's prefill fills: its ``init_cache``, or on
    DTensors zeros placed by its ``cache_spec``'s logical axes."""
    if not is_dtensor(x):
        return init_cache(cfg, batch, cache_len, dtype, device=x.device)
    spec, axes = cache_spec(cfg, batch, cache_len, dtype)
    dev = x.to_local().device
    return {k: zeros(shape, dt, dev, *axes[k])
            for k, (shape, dt) in spec.items()}


def cache_attend_sharded(q, k_new, v_new, ck, cv, pos, layout="bksd",
                         backend: Optional[str] = None):
    """:func:`cache_write` then :func:`attention_decode` (one position
    ``pos`` for every lane) on DTensor caches placed by the active rules,
    each rank on its own shards: it writes the token if its ring slot
    lies in the rank's block of slots, and the split softmax over a
    slot-split cache is merged across the ranks (max, then the rescaled
    sums).  q (B, 1, H, D); caches (B, KV, S, D) ('bksd') or (B, S, KV,
    D) ('bskd'), written in place, and k_new, v_new one token in the
    same layout.  With ``k_new`` None nothing is written and every slot
    is valid (the encoder-decoder's cross-attention cache, its slots not
    split).  Returns (B, 1, H, D).

    ``backend``: 'ref' (the einsum split softmax above), 'cuda' (B6 over
    the rank's ring, ``valid_len = min(pos + 1, S)``; it needs every
    slot on the rank, else it raises), or None/'auto': B6 where a rank
    holds every slot and the caches lie on the card, 'ref' elsewhere
    (there a memory count charges B6, ``launch.memory``)."""
    from torch.distributed import _functional_collectives as fc

    from repro_torch.launch.compat import shard_map
    from repro_torch.sharding_hints import logical_to_spec
    mesh = ck.device_mesh
    if layout not in ("bksd", "bskd"):
        raise ValueError(f"unknown layout {layout!r}")
    sax, kax = (2, 1) if layout == "bksd" else (1, 2)
    seq = "cache_seq" if k_new is not None else None
    axes = [None] * 4
    axes[0], axes[sax], axes[kax] = "batch", seq, "tp_kv"
    cspec = logical_to_spec(tuple(axes), shape=ck.shape)
    seq_axes = _axes_of(cspec[sax])
    qspec = (cspec[0], None, cspec[kax], None)
    nspec = tuple(None if i == sax else a for i, a in enumerate(cspec))
    s_total, d = ck.shape[sax], q.shape[-1]
    s0, s_loc = _shard_offset(mesh, seq_axes, s_total)
    whole = s_loc == s_total
    if backend not in (None, "auto", "ref", "cuda"):
        raise ValueError(f"unknown cache attention backend {backend!r}")
    if backend == "cuda" and not whole:
        raise ValueError("cache_attend_sharded: the cuda backend (B6) takes "
                         "a rank's whole ring; its slots are split "
                         f"{s_loc} of {s_total}")
    groups = [mesh.get_group(a) for a in seq_axes]
    eq_s, eq_o = ("bkgd,bksd->bkgs", "bkgs,bksd->bkgd") if layout == "bksd" \
        else ("bkgd,bskd->bkgs", "bkgs,bskd->bkgd")

    def body(ql, ckl, cvl, *new):
        if new:
            kn, vn, p = new
            idx = torch.remainder(p, s_total)
            hit = (idx >= s0) & (idx < s0 + s_loc)
            li = torch.clamp(idx - s0, 0, s_loc - 1).reshape(1).long()
            for cache, t in ((ckl, kn), (cvl, vn)):
                old = cache.index_select(sax, li)
                cache.index_copy_(sax, li, torch.where(hit, t.to(cache.dtype),
                                                       old))
        p = new[2] if new else None
        if backend == "ref" or not whole:
            return attend(ql, ckl, cvl, p)
        if backend == "cuda" or ckl.is_cuda:
            return ring(ql, ckl, cvl, p)
        # the card would run B6: a memory count charges it
        from repro_torch.launch.memory import as_kernel
        return as_kernel(attend, ring, ql, ckl, cvl, p)

    def ring(ql, ckl, cvl, p):
        from repro_torch.kernels import ops as kops
        valid = s_total if p is None else torch.clamp_max(p + 1, s_total)
        return kops.decode_attention(ql[:, 0], ckl, cvl, valid,
                                     layout=layout)[:, None]

    def attend(ql, ckl, cvl, p):
        dev = ckl.device
        slots = torch.arange(s0, s0 + s_loc, device=dev)
        if p is not None:
            valid = (slots < torch.clamp_max(p + 1, s_total))[None, None, None]
        else:
            valid = torch.ones((1, 1, 1, s_loc), dtype=torch.bool, device=dev)
        b, _, h, _ = ql.shape
        kvh = ckl.shape[kax]
        cdt = ckl.dtype
        qg = ql[:, 0].reshape(b, kvh, h // kvh, d)
        scores = torch.einsum(eq_s, qg.to(cdt).float(),
                              ckl.float()) / math.sqrt(d)
        scores = torch.where(valid, scores, NEG_INF)
        m = scores.amax(dim=-1, keepdim=True)
        for g in groups:
            m = fc.all_reduce(m, "max", g)
        e = torch.where(valid, torch.exp(scores - m), 0.0)
        l = e.sum(dim=-1, keepdim=True)
        o = torch.einsum(eq_o, e.to(cdt).float(), cvl.float())
        for g in groups:
            l = fc.all_reduce(l, "sum", g)
            o = fc.all_reduce(o, "sum", g)
        return (o / l).reshape(b, 1, h, d).to(ql.dtype)

    args, specs = (q, ck, cv), (qspec, cspec, cspec)
    if k_new is not None:
        args, specs = args + (k_new, v_new, pos), specs + (nspec, nspec, ())
    fn = shard_map(body, mesh=mesh, in_specs=specs, out_specs=qspec)
    return fn(*args)


# ---------------------------------------------------------------------------
# KV cache writes (ring buffer when the cache is shorter than the stream)
# ---------------------------------------------------------------------------


def as_device_scalar(x, device) -> torch.Tensor:
    """An int or a tensor as a tensor on ``device``, without a blocking
    host-to-device copy (``torch.full`` fills on the device)."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.full((), x, device=device)


def lane_index(slot, device) -> torch.Tensor:
    """A lane as a (1,) int64 index on ``device``: a tensor as it is (the
    scheduler's admission writes its lane through one on the device, so
    that a captured admission serves every lane), an int through a fill
    on the device."""
    if isinstance(slot, torch.Tensor):
        return slot.reshape(1).to(device=device, dtype=torch.long)
    return torch.full((1,), slot, dtype=torch.long, device=device)


def splice_lane(leaf, row, lane, axis: int = 1) -> None:
    """Write a B=1 cache ``row`` into lane ``lane`` (a (1,) index) of
    ``leaf`` along ``axis``, in place, in ``leaf``'s dtype."""
    leaf.index_copy_(axis, lane, row.to(leaf.dtype))


def set_table_row(table, lane, pages) -> None:
    """Rewrite lane ``lane``'s row of a (B, W) page ``table`` in place:
    ``pages`` (n,) first, the garbage page 0 after them."""
    row = torch.zeros((1, table.shape[1]), dtype=table.dtype,
                      device=table.device)
    row[0, :pages.shape[0]] = pages.to(table.dtype)
    table.index_copy_(0, lane, row)


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
    backends = REGISTRY.op("decode_attention").backends
    kw = {}
    if quantized:
        kw.update(k_scale=k_scale, v_scale=v_scale)
    if paged:
        kw.update(page_table=page_table)
    if "ref" in name and backend in (None, "auto"):
        # the card would run the name's kernel twin: a memory count
        # charges it
        from repro_torch.launch.memory import as_kernel
        return as_kernel(backends[name], backends[name.replace("ref", "cuda")],
                         q, k_cache, v_cache, valid_len, layout=layout, **kw)
    return backends[name](q, k_cache, v_cache, valid_len, layout=layout,
                          **kw)


FLASH_BACKENDS = ("ref", "cuda")


def resolve_flash_backend(name: Optional[str], device=None) -> str:
    """``None``/'auto' -> 'cuda' on a CUDA device, 'ref' elsewhere; 'ref'
    and 'cuda' as they are; any other name raises."""
    if name in (None, "auto"):
        return "cuda" if torch.device(device or "cpu").type == "cuda" else "ref"
    if name not in FLASH_BACKENDS:
        raise ValueError(f"unknown flash attention backend {name!r} "
                         f"(known: {list(FLASH_BACKENDS)} or 'auto')")
    return name


def flash_backend_of(decode_backend: Optional[str]) -> Optional[str]:
    """The flash attention backend that goes with a decode backend name:
    its family ('ref' for 'ref', 'paged_ref_q8', ...; 'cuda' for the
    kernels), None for None/'auto' (both then resolve by device)."""
    if decode_backend in (None, "auto"):
        return None
    return "ref" if "ref" in decode_backend else "cuda"


def flash_attention_named(q, k, v, *, causal: bool = True, window: int = 0,
                          backend: Optional[str] = None,
                          save_memory: bool = False):
    """Full-sequence attention (prefill and training) through a named
    backend: 'ref' (:func:`attention_chunked`), 'cuda' (the flash kernels:
    B9's differentiable forward when grad is on and an input requires
    it, else B8), or None/'auto' (cuda on a CUDA tensor, ref on a CPU
    one).  q (B, Sq, H, D); k, v (B, Sk, KV, D), query positions from 0.
    On DTensors it runs on each rank's shards (:func:`_sharded_attention`).
    ``save_memory`` reaches the 'ref' backend only.  Where None/'auto'
    resolves to 'ref' (no card), a memory count charges what the kernels
    allocate (``launch.memory.flash_attention``)."""
    if is_dtensor(q):
        return _sharded_attention(q, k, v, causal=causal, window=window,
                                  backend=backend, save_memory=save_memory)
    name = resolve_flash_backend(backend, q.device)
    if name == "cuda":
        from repro_torch.kernels import ops as kops
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            return kops.flash_attention_trainable(q, k, v, causal, window)
        return kops.flash_attention(q, k, v, causal=causal, window=window)
    plain = functools.partial(attention_chunked, causal=causal,
                              window=window, save_memory=save_memory)
    if backend in (None, "auto"):
        # the card would run B8/B9: a memory count charges them
        from repro_torch.launch import memory
        return memory.flash_attention(plain, q, k, v, causal=causal,
                                      window=window)
    return plain(q, k, v)


def _axes_of(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _shard_offset(mesh, axes, n: int) -> Tuple[int, int]:
    """(first index, count) of this rank's block of a dim of size ``n``
    split over mesh ``axes`` (row-major over them, as DTensor splits)."""
    names = list(mesh.mesh_dim_names)
    coord = mesh.get_coordinate()
    block, count = 0, n
    for a in axes:
        size = mesh.shape[names.index(a)]
        count //= size
        block = block * size + coord[names.index(a)]
    return block * count, count


def _sharded_attention(q, k, v, *, causal, window, backend, save_memory):
    """Attention on DTensors: q split on (batch, heads), k/v on (batch,
    kv_heads) by the active rules, and on each rank the same backend on
    the local shards (the kernel on the card, the plain version on the
    CPU).  Where the model axis splits q heads but not kv heads, each
    rank takes the kv heads of its own q heads (q head h meets kv head
    h // G): a slice where its heads cover whole groups, else one kv head
    per q head; the kv gradients are then partial sums over that axis."""
    from torch.distributed.tensor import Partial

    from repro_torch.launch.compat import shard_map
    from repro_torch.sharding_hints import logical_to_spec, to_placements
    mesh = q.device_mesh
    h, kvh = q.shape[2], k.shape[2]
    groups = h // kvh
    qspec = logical_to_spec(("batch", None, "heads", None), shape=q.shape)
    kspec = logical_to_spec(("batch", None, "kv_heads", None), shape=k.shape)
    q_axes, kv_axes = _axes_of(qspec[2]), _axes_of(kspec[2])
    h0, hl = _shard_offset(mesh, q_axes, h)
    if kv_axes == q_axes:
        pick = None                        # local kv heads = own groups
    elif kv_axes:
        raise ValueError(f"kv heads split over {kv_axes} but q heads over "
                         f"{q_axes}")
    elif hl % groups == 0 and h0 % groups == 0:
        pick = slice(h0 // groups, (h0 + hl) // groups)
    else:
        pick = torch.arange(h0, h0 + hl) // groups

    def body(ql, kl_, vl_):
        if isinstance(pick, slice):
            kl_, vl_ = kl_[:, :, pick], vl_[:, :, pick]
        elif pick is not None:
            idx = pick.to(kl_.device)
            kl_, vl_ = kl_.index_select(2, idx), vl_.index_select(2, idx)
        return flash_attention_named(ql, kl_, vl_, causal=causal,
                                     window=window, backend=backend,
                                     save_memory=save_memory)

    kv_pl = to_placements(kspec, mesh)
    kv_grad = tuple(Partial() if n in q_axes and n not in kv_axes else p
                    for n, p in zip(mesh.mesh_dim_names, kv_pl))
    fn = shard_map(body, mesh=mesh, in_specs=(qspec, kspec, kspec),
                   out_specs=qspec, in_grad_specs=(qspec, kv_grad, kv_grad))
    return fn(q, k, v)


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def softmax_xent(logits, labels, mask=None):
    """Mean next-token cross entropy. logits (B, S, V), labels (B, S);
    with ``mask`` (B, S) the mean over the unmasked positions.  On
    DTensors each rank keeps its own vocab shard (:func:`_sharded_nll`)."""
    if is_dtensor(logits):
        nll = _sharded_nll(logits, labels)
    else:
        logits = logits.float()
        logz = torch.logsumexp(logits, dim=-1, keepdim=True)
        ll = torch.gather(logits, -1, labels[..., None].long())
        nll = (logz - ll)[..., 0]
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)


class _VocabShardNll(torch.autograd.Function):
    """Per-position cross entropy over a vocab split across ranks
    (Megatron's vocab-parallel cross entropy): x (B, S, Vl) this rank's
    logits for vocab rows [v0, v0 + Vl), labels (B, S) global ids.  The
    max, the sum of exponentials and the label's logit (0 on a rank that
    lacks the label) are all-reduced over ``groups``; the gradient is the
    local softmax minus the local one-hot, with no collective.  Only the
    input and logz are saved: the backward forms the softmax again."""

    @staticmethod
    def forward(ctx, x, labels, v0, groups):
        from torch.distributed import _functional_collectives as fc
        vl = x.shape[-1]
        idx = labels.long() - v0
        hit = (idx >= 0) & (idx < vl)
        idx = torch.clamp(idx, 0, vl - 1)[..., None]
        m = x.amax(dim=-1, keepdim=True).float()
        for g in groups:
            m = fc.all_reduce(m, "max", g)
        e = x.to(torch.float32, copy=True)
        e.sub_(m).exp_()
        se = e.sum(dim=-1, keepdim=True)
        del e
        ll = torch.where(hit, torch.gather(x, -1, idx)[..., 0].float(), 0.0)
        for g in groups:
            se = fc.all_reduce(se, "sum", g)
            ll = fc.all_reduce(ll, "sum", g)
        logz = m + torch.log(se)
        ctx.save_for_backward(x, logz, idx, hit)
        return logz[..., 0] - ll

    @staticmethod
    def backward(ctx, g):
        x, logz, idx, hit = ctx.saved_tensors
        p = x.to(torch.float32, copy=True)
        p.sub_(logz).exp_()
        p.scatter_add_(-1, idx, -hit[..., None].float())
        p.mul_(g[..., None])
        return p.to(x.dtype), None, None, None


def _sharded_nll(logits, labels):
    """:func:`softmax_xent`'s per-position losses on DTensor logits placed
    (batch, seq, vocab_act) by the active rules: each rank takes its own
    vocab shard in a ``compat.shard_map`` body (:class:`_VocabShardNll`)
    and gets the (B, S) losses of its batch shard, the same on every rank
    of the vocab axes; no rank forms the whole (B, S, V) logits or their
    gradient.  Labels meet the logits' batch and seq placements."""
    from repro_torch.launch.compat import shard_map
    from repro_torch.sharding_hints import logical_to_spec
    mesh = logits.device_mesh
    spec = logical_to_spec(("batch", "seq", "vocab_act"), shape=logits.shape)
    v_axes = _axes_of(spec[2])
    v0, _ = _shard_offset(mesh, v_axes, logits.shape[-1])
    groups = [mesh.get_group(a) for a in v_axes]

    def body(xl, ll):
        return _VocabShardNll.apply(xl, ll, v0, groups)

    fn = shard_map(body, mesh=mesh, in_specs=(spec, spec[:2]),
                   out_specs=spec[:2])
    return fn(logits, labels)
