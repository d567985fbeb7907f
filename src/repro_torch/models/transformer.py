"""Dense decoder-only transformer (llama / qwen / tinyllama families): the
serving path.

The port of ``repro.models.transformer``.  Parameters keep the JAX tree,
layers stacked along a leading L axis; the JAX package's ``lax.scan``
over layers becomes a Python loop over views ``params["layers"][n][l]``
and over the layer views ``cache[...][l]`` of the (L, ...) caches, which
the decode step updates in place.  The products stay ``torch.matmul``
(the JAX package leaves them to XLA outside any Pallas kernel); decode
attention goes through the op registry's named backends.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.quantize import quantize_into
from repro_torch.models import common as cm
from repro_torch.models.common import P

# ---------------------------------------------------------------------------
# Templates
# ---------------------------------------------------------------------------


def _attn_template(cfg: ArchConfig, L: int) -> Dict[str, P]:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    t = {
        "ln1": P((L, d), (None, None), "zeros"),
        "wq": P((L, d, cfg.q_dim), (None, "fsdp", "tp_heads")),
        "wk": P((L, d, cfg.kv_dim), (None, "fsdp", "tp_kv")),
        "wv": P((L, d, cfg.kv_dim), (None, "fsdp", "tp_kv")),
        "wo": P((L, cfg.q_dim, d), (None, "tp_heads", "fsdp")),
    }
    if cfg.qk_norm:
        t["q_norm"] = P((L, hd), (None, None), "zeros")
        t["k_norm"] = P((L, hd), (None, None), "zeros")
    return t


def _mlp_template(cfg: ArchConfig, L: int) -> Dict[str, P]:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "ln2": P((L, d), (None, None), "zeros"),
        "w_gate": P((L, d, f), (None, "fsdp", "tp_ff")),
        "w_up": P((L, d, f), (None, "fsdp", "tp_ff")),
        "w_down": P((L, f, d), (None, "tp_ff", "fsdp")),
    }


def param_template(cfg: ArchConfig):
    L = cfg.num_layers
    t = {
        "embed": P((cfg.vocab_size, cfg.d_model), ("tp_vocab", "fsdp"),
                   "embed"),
        "final_ln": P((cfg.d_model,), (None,), "zeros"),
        "layers": {**_attn_template(cfg, L), **_mlp_template(cfg, L)},
    }
    if not cfg.tie_embeddings:
        t["unembed"] = P((cfg.d_model, cfg.vocab_size), ("fsdp", "tp_vocab"))
    return t


def _layer(params, l: int):
    """Layer ``l``'s parameters: views into the stacked tensors."""
    return {k: w[l] for k, w in params["layers"].items()}


# ---------------------------------------------------------------------------
# Layer pieces
# ---------------------------------------------------------------------------


def _qkv(cfg: ArchConfig, lp, x, positions):
    """Normed, projected, qk-normed and rotated q (B,S,H,D), k, v
    (B,S,KV,D)."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    xn = cm.rms_norm(x, lp["ln1"], cfg.norm_eps)
    q = (xn @ lp["wq"]).reshape(b, s, cfg.num_heads, hd)
    k = (xn @ lp["wk"]).reshape(b, s, cfg.num_kv_heads, hd)
    v = (xn @ lp["wv"]).reshape(b, s, cfg.num_kv_heads, hd)
    if cfg.qk_norm:
        q = cm.rms_norm(q, lp["q_norm"], cfg.norm_eps)
        k = cm.rms_norm(k, lp["k_norm"], cfg.norm_eps)
    q = cm.apply_rope(q, positions, cfg.rope_theta)
    k = cm.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn(cfg: ArchConfig, lp, x, *, window: int = 0, q_offset: int = 0,
         positions=None):
    """Self-attention over a full sequence (prefill).  Returns
    (output, (k, v)) so callers can populate a KV cache."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :] + q_offset
    q, k, v = _qkv(cfg, lp, x, positions)
    out = cm.attention_chunked(q, k, v, causal=True, window=window)
    return out.reshape(b, s, cfg.q_dim) @ lp["wo"], (k, v)


def attn_decode(cfg: ArchConfig, lp, x, ck, cv, pos, *, window: int = 0):
    """One-token attention against a ring cache, B lanes at one position:
    x (B, 1, d); caches (B, KV, S, D) written in place; pos an int or a
    0-dim tensor."""
    b = x.shape[0]
    pos_t = cm.as_device_scalar(pos, x.device)
    q, k, v = _qkv(cfg, lp, x, pos_t.reshape(1, 1).expand(b, 1))
    cm.cache_write(ck, cv, k.transpose(1, 2), v.transpose(1, 2), pos_t,
                   seq_axis=2)
    valid = cm.cache_valid_len(pos_t, ck.shape[2])
    out = cm.attention_decode(q, ck, cv, valid, layout="bksd")
    return out.reshape(b, 1, cfg.q_dim) @ lp["wo"]


def attn_decode_batch(cfg: ArchConfig, lp, x, ck, cv, pos, *,
                      window: int = 0, backend=None, cks=None, cvs=None,
                      page_table=None):
    """Lane-major ragged decode attention: x (B, 1, d); pos (B,) per-lane
    positions; one fused attention call across all lanes.  Caches are
    (B, KV, S, D) rings, or with ``page_table`` (B, W) the (P, KV, ps, D)
    pools; ``cks``/``cvs`` (per-slot scales) mark an int8 cache.  The
    caches are written in place; returns the attention output."""
    b = x.shape[0]
    paged = page_table is not None
    cache_size = page_table.shape[1] * ck.shape[2] if paged else ck.shape[2]
    q, k, v = _qkv(cfg, lp, x, pos[:, None])
    kT, vT = k.transpose(1, 2), v.transpose(1, 2)
    valid = cm.cache_valid_len(pos, cache_size)        # (B,) ragged
    if cks is None:
        if paged:
            cm.cache_write_batch_paged(ck, cv, page_table, kT, vT, pos)
        else:
            cm.cache_write_batch(ck, cv, kT, vT, pos)
        out = cm.decode_attention_named(q, ck, cv, valid, layout="bksd",
                                        backend=backend,
                                        page_table=page_table)
    else:
        if paged:
            cm.cache_write_batch_paged_q8(ck, cv, cks, cvs, page_table, kT,
                                          vT, pos)
        else:
            cm.cache_write_batch_q8(ck, cv, cks, cvs, kT, vT, pos)
        out = cm.decode_attention_named(q, ck, cv, valid, layout="bksd",
                                        backend=backend, k_scale=cks,
                                        v_scale=cvs, page_table=page_table)
    return out.reshape(b, 1, cfg.q_dim) @ lp["wo"]


def mlp(cfg: ArchConfig, lp, x):
    xn = cm.rms_norm(x, lp["ln2"], cfg.norm_eps)
    return cm.swiglu(xn, lp["w_gate"], lp["w_up"], lp["w_down"])


def _logits(cfg: ArchConfig, params, x):
    x = cm.rms_norm(x, params["final_ln"], cfg.norm_eps)
    w = params["embed"].t() if cfg.tie_embeddings else params["unembed"]
    return x @ w.to(x.dtype)


def _embed(cfg: ArchConfig, params, tokens):
    return params["embed"][tokens]


# ---------------------------------------------------------------------------
# Forward / decode
# ---------------------------------------------------------------------------


def forward(cfg: ArchConfig, params, tokens, *, window: int = 0):
    """tokens (B, S) -> logits (B, S, V)."""
    x = _embed(cfg, params, tokens)
    for l in range(cfg.num_layers):
        lp = _layer(params, l)
        x = x + attn(cfg, lp, x, window=window)[0]
        x = x + mlp(cfg, lp, x)
    return _logits(cfg, params, x)


_KV_DTYPES = {None: None, "bf16": torch.bfloat16, "int8": torch.int8}


def kv_cache_dtype(dtype, kv_dtype):
    """The K/V buffer dtype for a ``kv_dtype`` option: None keeps
    ``dtype``, 'bf16' halves KV bytes, 'int8' quarters them (plus
    per-slot fp32 scales)."""
    if kv_dtype not in _KV_DTYPES:
        raise ValueError(f"unknown kv_dtype {kv_dtype!r} "
                         "(expected None, 'bf16' or 'int8')")
    return _KV_DTYPES[kv_dtype] or dtype


def init_cache(cfg: ArchConfig, batch: int, cache_len: int,
               dtype=torch.bfloat16, kv_dtype=None, page_size=None,
               num_pages=None, device="cpu"):
    """Decoder-only cache layout: (L, B, KV, S, D) ('bksd'), int8 with
    (L, B, KV, S) fp32 scales.  With ``page_size`` the paged layout:
    pools (L, P, KV, ps, D) and a shared (B, W) int32 ``page_table``,
    W = ceil(cache_len / ps); page 0 is the reserved garbage page."""
    L, kv, hd = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim
    kvd = kv_cache_dtype(dtype, kv_dtype)
    z = lambda shape, dt=kvd: torch.zeros(shape, dtype=dt, device=device)
    if page_size is None:
        cache = {"k": z((L, batch, kv, cache_len, hd)),
                 "v": z((L, batch, kv, cache_len, hd))}
        if kv_dtype == "int8":
            cache["k_scale"] = z((L, batch, kv, cache_len), torch.float32)
            cache["v_scale"] = z((L, batch, kv, cache_len), torch.float32)
        return cache
    ps = page_size
    w = -(-cache_len // ps)
    p = num_pages if num_pages is not None else 1 + batch * w
    cache = {"k_pages": z((L, p, kv, ps, hd)),
             "v_pages": z((L, p, kv, ps, hd)),
             "page_table": z((batch, w), torch.int32)}
    if kv_dtype == "int8":
        cache["k_scale_pages"] = z((L, p, kv, ps), torch.float32)
        cache["v_scale_pages"] = z((L, p, kv, ps), torch.float32)
    return cache


def paged_info(cfg: ArchConfig, cache_len: int, page_size: int):
    """Paging capabilities: incremental page allocation and prompt-prefix
    sharing; logical capacity rounds cache_len up to whole pages."""
    w = -(-cache_len // page_size)
    return {"pages_per_lane": w, "capacity": w * page_size,
            "alloc": "incremental", "prefix_sharing": True}


def cache_splice_paged(cfg: ArchConfig, cache, row, slot: int, pages,
                       page_size: int):
    """Splice a prefilled B=1 ring cache ``row`` into lane ``slot`` of a
    paged ``cache``, in place: its first ``len(pages)`` KV blocks go to
    the given pool pages and the lane's table row is rewritten."""
    n = pages.shape[0]
    ps = page_size
    pages = pages.to(device=cache["page_table"].device, dtype=torch.long)
    for key in ("k", "v"):
        src = row[key][:, 0, :, :n * ps]               # (L, KV, n*ps, D)
        L, kv = src.shape[0], src.shape[1]
        x = src.reshape(L, kv, n, ps, -1).transpose(1, 2)
        pool = cache[key + "_pages"]
        pool[:, pages] = x.to(pool.dtype)
        skey = key + "_scale"
        if skey in row:
            ssrc = row[skey][:, 0, :, :n * ps]         # (L, KV, n*ps)
            cache[skey + "_pages"][:, pages] = \
                ssrc.reshape(L, kv, n, ps).transpose(1, 2)
    table = cache["page_table"]
    table[slot].fill_(0)
    table[slot, :n] = pages.to(table.dtype)
    return cache


def cache_to_kv_dtype(cfg: ArchConfig, cache, kv_dtype):
    """Convert a float prefill cache into the ``kv_dtype`` layout of
    :func:`init_cache`; 'int8' quantizes each slot over head_dim."""
    if kv_dtype is None:
        return cache
    if kv_dtype == "bf16":
        return {**cache, "k": cache["k"].to(torch.bfloat16),
                "v": cache["v"].to(torch.bfloat16)}
    if kv_dtype != "int8":
        raise ValueError(f"unknown kv_dtype {kv_dtype!r}")
    kq, ks = quantize_into(cache["k"], axis=-1)
    vq, vs = quantize_into(cache["v"], axis=-1)
    return {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}


def decode_step(cfg: ArchConfig, params, token, cache, pos, *,
                window: int = 0):
    """token (B, 1) int; pos an int or 0-dim tensor, shared by the
    lanes.  Writes the ring cache in place; returns (logits, cache)."""
    x = _embed(cfg, params, token)
    for l in range(cfg.num_layers):
        lp = _layer(params, l)
        x = x + attn_decode(cfg, lp, x, cache["k"][l], cache["v"][l], pos,
                            window=window)
        x = x + mlp(cfg, lp, x)
    return _logits(cfg, params, x), cache


def decode_step_batch(cfg: ArchConfig, params, tokens, cache, pos, *,
                      window: int = 0, attn_backend=None):
    """Lane-major decode: tokens (B, 1); pos (B,) per-lane positions.
    The continuous-batching hot path: batched QKV projections, per-lane
    RoPE and cache writes, and one fused ragged attention call per layer.
    An int8 cache (``k_scale``) takes the quantizing write and the q8
    attention; a paged cache (``page_table``) the pools.  Writes the
    cache in place; returns (logits (B, 1, V), cache)."""
    x = _embed(cfg, params, tokens)
    if "page_table" in cache:
        return _decode_step_batch_paged(cfg, params, x, cache, pos,
                                        window=window,
                                        attn_backend=attn_backend)
    quantized = "k_scale" in cache
    for l in range(cfg.num_layers):
        lp = _layer(params, l)
        scales = dict(cks=cache["k_scale"][l], cvs=cache["v_scale"][l]) \
            if quantized else {}
        x = x + attn_decode_batch(cfg, lp, x, cache["k"][l], cache["v"][l],
                                  pos, window=window, backend=attn_backend,
                                  **scales)
        x = x + mlp(cfg, lp, x)
    return _logits(cfg, params, x), cache


def _decode_step_batch_paged(cfg: ArchConfig, params, x, cache, pos, *,
                             window: int = 0, attn_backend=None):
    """Paged twin of :func:`decode_step_batch`: per-layer pool views, the
    (B, W) page table shared by every layer."""
    pt = cache["page_table"]
    quantized = "k_scale_pages" in cache
    for l in range(cfg.num_layers):
        lp = _layer(params, l)
        scales = dict(cks=cache["k_scale_pages"][l],
                      cvs=cache["v_scale_pages"][l]) if quantized else {}
        x = x + attn_decode_batch(cfg, lp, x, cache["k_pages"][l],
                                  cache["v_pages"][l], pos, window=window,
                                  backend=attn_backend, page_table=pt,
                                  **scales)
        x = x + mlp(cfg, lp, x)
    return _logits(cfg, params, x), cache


def prefill(cfg: ArchConfig, params, tokens, cache_len: int,
            *, window: int = 0, cache_dtype=torch.bfloat16):
    """Run the full prompt, returning logits and a populated ring cache.
    A prompt longer than ``cache_len`` keeps its last ``cache_len``
    tokens, rolled so that token t lives at slot t % cache_len."""
    b, s = tokens.shape
    x = _embed(cfg, params, tokens)
    cache = init_cache(cfg, b, cache_len, cache_dtype, device=x.device)
    keep = min(s, cache_len)
    for l in range(cfg.num_layers):
        lp = _layer(params, l)
        a, (k, v) = attn(cfg, lp, x, window=window)
        x = x + a
        x = x + mlp(cfg, lp, x)
        # (B, S, KV, D) -> bksd (B, KV, S, D)
        cache["k"][l, :, :, :keep] = k[:, s - keep:].transpose(1, 2)
        cache["v"][l, :, :, :keep] = v[:, s - keep:].transpose(1, 2)
    if s > cache_len:
        shift = s % cache_len
        cache["k"] = torch.roll(cache["k"], shift, dims=3)
        cache["v"] = torch.roll(cache["v"], shift, dims=3)
    return _logits(cfg, params, x), cache
