"""Whisper-style encoder-decoder transformer backbone (audio family).

The port of ``repro.models.encdec`` [arXiv:2212.04356].  The
mel-spectrogram + conv feature extractor is a stub, as in the JAX
package: the model consumes precomputed frame embeddings (B, encoder_seq,
d_model).  Encoder: bidirectional self-attention with sinusoidal
positions, LayerNorm + GELU MLP (the tanh GELU, ``jax.nn.gelu``'s
default).  Decoder: causal self-attention with RoPE (the JAX package's
deliberate departure from Whisper's learned 448-position table) +
cross-attention to the encoder output + GELU MLP.  q and v carry biases,
k none.

Full-sequence attention (the encoder, the decoder's causal prefill and
the cross-attention prefill) goes through ``flash_attention_named``: B8
on the card, B9's trainable form where grads are taken, and the JAX
package's ``attention_chunked`` on the ``ref`` backend.  The decode
caches keep the JAX layout, 'bskd': (L, B, S, KV, D) rings and (L, P,
ps, KV, D) pages.  The decoder's self-attention decode goes through the
named decode backends (B6, B7, fp32, bf16 or int8).  The cross-attention
caches ``xk``/``xv`` are written once at admission, stay float (bf16
under ``kv_dtype="bf16"``) and dense per lane when paged; the lane-major
decode step reads them through B6's unquantized ring form with every
lane's valid length the encoder's (the JAX package calls the plain
``attention_decode`` there: the same function).

As in ``models/transformer.py``, layers are Python loops over views of
the stacked weights and caches, the decode steps write the caches in
place, and ``jax.checkpoint`` over the decoder layers becomes
``torch.utils.checkpoint`` (non-reentrant).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.quantize import quantize_into
from repro_torch.models import common as cm
from repro_torch.models import transformer as tfm
from repro_torch.models.common import P
from repro_torch.sharding_hints import checkpoint, hint, is_dtensor

# The scheduler captures the batched decode step once as a CUDA graph
# (runtime/scheduler.py): decode_step_batch reads no device value on the
# host and no shape depends on data.  Its cross-attention runs B6's ring
# form over the lanes' dense xk/xv ('bskd', encoder_seq slots, several
# splits merged through the ticket counters, which the last CTA resets);
# its self-attention runs B6/B7 over the ring or the pages; the cache
# writes and the admission splice (cache_splice_paged) are in place.
# ``enc_valid`` is a fresh ``torch.full`` inside the step: it lands in the
# graph's pool, and its value never changes.
CUDA_GRAPH_SAFE = True


def _ln(x, lp, name, eps=1e-5):
    return cm.layer_norm(x, lp[f"{name}_w"], lp[f"{name}_b"], eps)


def _attn_t(cfg: ArchConfig, L: int, prefix: str = ""):
    d = cfg.d_model
    return {
        f"{prefix}ln_w": P((L, d), (None, None), "ones"),
        f"{prefix}ln_b": P((L, d), (None, None), "zeros"),
        f"{prefix}wq": P((L, d, cfg.q_dim), (None, "fsdp", "tp_heads")),
        f"{prefix}bq": P((L, cfg.q_dim), (None, "tp_heads"), "zeros"),
        f"{prefix}wk": P((L, d, cfg.kv_dim), (None, "fsdp", "tp_kv")),
        f"{prefix}wv": P((L, d, cfg.kv_dim), (None, "fsdp", "tp_kv")),
        f"{prefix}bv": P((L, cfg.kv_dim), (None, "tp_kv"), "zeros"),
        f"{prefix}wo": P((L, cfg.q_dim, d), (None, "tp_heads", "fsdp")),
        f"{prefix}bo": P((L, d), (None, "fsdp"), "zeros"),
    }


def _mlp_t(cfg: ArchConfig, L: int):
    d, f = cfg.d_model, cfg.d_ff
    return {
        "mlp_ln_w": P((L, d), (None, None), "ones"),
        "mlp_ln_b": P((L, d), (None, None), "zeros"),
        "w_in": P((L, d, f), (None, "fsdp", "tp_ff")),
        "b_in": P((L, f), (None, "tp_ff"), "zeros"),
        "w_out": P((L, f, d), (None, "tp_ff", "fsdp")),
        "b_out": P((L, d), (None, "fsdp"), "zeros"),
    }


def param_template(cfg: ArchConfig):
    d = cfg.d_model
    return {
        "embed": P((cfg.vocab_size, d), ("tp_vocab", "fsdp"), "embed"),
        "enc_final_ln_w": P((d,), (None,), "ones"),
        "enc_final_ln_b": P((d,), (None,), "zeros"),
        "final_ln_w": P((d,), (None,), "ones"),
        "final_ln_b": P((d,), (None,), "zeros"),
        "enc": {**_attn_t(cfg, cfg.encoder_layers),
                **_mlp_t(cfg, cfg.encoder_layers)},
        "dec": {**_attn_t(cfg, cfg.num_layers),
                **_attn_t(cfg, cfg.num_layers, prefix="x_"),
                **_mlp_t(cfg, cfg.num_layers)},
    }


def _layers(stack, unbind: bool = False):
    """Per-layer parameter views of a stacked tree.  ``unbind`` splits
    each tensor once (so that its gradients are stacked once)."""
    if unbind:
        split = {k: w.unbind(0) for k, w in stack.items()}
        n = len(next(iter(split.values())))
        return [{k: w[i] for k, w in split.items()} for i in range(n)]
    n = next(iter(stack.values())).shape[0]
    return [{k: w[i] for k, w in stack.items()} for i in range(n)]


def sinusoid(seq: int, d: int, device=None):
    """(seq, d) fp32: sin of the position's angles, then their cos."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(10000.0, 2 * dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _qkv(cfg: ArchConfig, lp, xq, xkv, prefix: str = ""):
    """q (B, Sq, H, D) from ``xq``; k, v (B, Skv, KV, D) from ``xkv``;
    biases on q and v, none on k."""
    b, sq = xq.shape[:2]
    skv = xkv.shape[1]
    hd = cfg.resolved_head_dim
    q = (xq @ lp[f"{prefix}wq"] + lp[f"{prefix}bq"]).reshape(
        b, sq, cfg.num_heads, hd)
    k = (xkv @ lp[f"{prefix}wk"]).reshape(b, skv, cfg.num_kv_heads, hd)
    v = (xkv @ lp[f"{prefix}wv"] + lp[f"{prefix}bv"]).reshape(
        b, skv, cfg.num_kv_heads, hd)
    return q, k, v


def _mlp(cfg: ArchConfig, lp, x):
    h = cm.gelu(_ln(x, lp, "mlp_ln") @ lp["w_in"] + lp["b_in"])
    h = hint(h, "batch", "seq", "ff")
    return hint(h @ lp["w_out"] + lp["b_out"], "batch", "seq", "embed")


def _out(cfg: ArchConfig, lp, a, prefix: str = ""):
    b, s = a.shape[:2]
    return a.reshape(b, s, cfg.q_dim) @ lp[f"{prefix}wo"] + lp[f"{prefix}bo"]


def enc_layer(cfg: ArchConfig, lp, x, backend=None):
    """One encoder layer: bidirectional self-attention, then the MLP."""
    xn = _ln(x, lp, "ln")
    q, k, v = _qkv(cfg, lp, xn, xn)
    a = cm.flash_attention_named(q, k, v, causal=False, backend=backend)
    x = x + _out(cfg, lp, a)
    return x + _mlp(cfg, lp, x)


def encode(cfg: ArchConfig, params, frames, *, backend: Optional[str] = None):
    """frames: (B, S_enc, d) stubbed conv-frontend output -> (B, S_enc, d).
    ``backend`` names the flash attention backend (None: by device)."""
    x = frames + sinusoid(frames.shape[1], cfg.d_model,
                          frames.device).to(frames.dtype)
    for lp in _layers(params["enc"], unbind=torch.is_grad_enabled()):
        x = enc_layer(cfg, lp, x, backend)
    return cm.layer_norm(x, params["enc_final_ln_w"], params["enc_final_ln_b"])


def _self_attn(cfg: ArchConfig, lp, x, *, window: int = 0, backend=None):
    """The decoder's causal self-attention over a full sequence (RoPE from
    position 0): (output, (k, v))."""
    s = x.shape[1]
    xn = _ln(x, lp, "ln")
    q, k, v = _qkv(cfg, lp, xn, xn)
    pos = torch.arange(s, device=x.device)[None]
    q = cm.apply_rope(q, pos, cfg.rope_theta)
    k = cm.apply_rope(k, pos, cfg.rope_theta)
    a = cm.flash_attention_named(q, k, v, causal=True, window=window,
                                 backend=backend)
    return _out(cfg, lp, a), (k, v)


def _cross_attn(cfg: ArchConfig, lp, x, enc_out, backend=None):
    """Cross-attention of the decoder's positions to the encoder output
    (non-causal): (output, (kx, vx))."""
    xn = _ln(x, lp, "x_ln")
    qx, kx, vx = _qkv(cfg, lp, xn, enc_out, prefix="x_")
    ax = cm.flash_attention_named(qx, kx, vx, causal=False, backend=backend)
    return _out(cfg, lp, ax, prefix="x_"), (kx, vx)


def _dec_layer(cfg: ArchConfig, lp, x, enc_out, *, window: int = 0,
               backend=None):
    """Returns (x, (self_k, self_v, cross_k, cross_v))."""
    a, (k, v) = _self_attn(cfg, lp, x, window=window, backend=backend)
    x = x + a
    ax, (kx, vx) = _cross_attn(cfg, lp, x, enc_out, backend)
    x = x + ax
    return x + _mlp(cfg, lp, x), (k, v, kx, vx)


def _dec_block(cfg, lp, x, enc_out, window, backend):
    return _dec_layer(cfg, lp, x, enc_out, window=window, backend=backend)[0]


def _logits(params, x):
    x = cm.layer_norm(x, params["final_ln_w"], params["final_ln_b"])
    return hint(x @ params["embed"].t().to(x.dtype), "batch", "seq",
                "vocab_act")


def forward(cfg: ArchConfig, params, tokens, frames, *, window: int = 0,
            remat: bool = True, backend: Optional[str] = None):
    """tokens (B, S), frames (B, S_enc, d) -> logits (B, S, V).  With
    ``remat`` and grad on, each decoder layer keeps only its input for
    the backward and runs again there (``jax.checkpoint`` over the
    decoder layers in the JAX package; the encoder is not
    rematerialized, as there)."""
    enc_out = encode(cfg, params, frames, backend=backend)
    x = cm.embed_lookup(params["embed"], tokens)
    grad = torch.is_grad_enabled()
    for lp in _layers(params["dec"], unbind=grad):
        if remat and grad:
            x = checkpoint(_dec_block, cfg, lp, x, enc_out, window, backend,
                           use_reentrant=False)
        else:
            x = _dec_block(cfg, lp, x, enc_out, window, backend)
    return _logits(params, x)


def loss_fn(cfg: ArchConfig, params, batch, *, window: int = 0,
            backend: Optional[str] = None):
    """Next-token cross entropy of ``batch`` {"tokens", "labels" (B, S),
    "frames" (B, S_enc, d)}: (loss, {"loss": loss})."""
    logits = forward(cfg, params, batch["tokens"], batch["frames"],
                     window=window, backend=backend)
    loss = cm.softmax_xent(logits[:, :-1], batch["labels"][:, 1:])
    return loss, {"loss": loss}


# ---------------------------------------------------------------------------
# Serving: caches, prefill and the decode steps
# ---------------------------------------------------------------------------


def init_cache(cfg: ArchConfig, batch: int, cache_len: int,
               dtype=torch.bfloat16, kv_dtype=None, page_size=None,
               num_pages=None, device="cpu"):
    """The cross-attention caches xk/xv (L, B, S_enc, KV, D) in ``dtype``
    (bf16 under ``kv_dtype="bf16"``, never int8) and the decoder's
    self-attention ring (L, B, S, KV, D) ('bskd'), int8 with (L, B, S, KV)
    fp32 scales; with ``page_size`` the pools (L, P, ps, KV, D) behind a
    (B, W) ``page_table`` (page 0 the reserved garbage page), xk/xv still
    dense per lane."""
    L, kv, hd = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim
    se = cfg.encoder_seq
    kvd = tfm.kv_cache_dtype(dtype, kv_dtype)
    xd = torch.bfloat16 if kv_dtype == "bf16" else dtype
    z = lambda shape, dt=kvd: torch.zeros(shape, dtype=dt, device=device)
    cache = {"xk": z((L, batch, se, kv, hd), xd),
             "xv": z((L, batch, se, kv, hd), xd)}
    if page_size is None:
        cache["k"] = z((L, batch, cache_len, kv, hd))
        cache["v"] = z((L, batch, cache_len, kv, hd))
        if kv_dtype == "int8":
            cache["k_scale"] = z((L, batch, cache_len, kv), torch.float32)
            cache["v_scale"] = z((L, batch, cache_len, kv), torch.float32)
        return cache
    ps = page_size
    w = -(-cache_len // ps)
    p = num_pages if num_pages is not None else 1 + batch * w
    cache["k_pages"] = z((L, p, ps, kv, hd))
    cache["v_pages"] = z((L, p, ps, kv, hd))
    cache["page_table"] = z((batch, w), torch.int32)
    if kv_dtype == "int8":
        cache["k_scale_pages"] = z((L, p, ps, kv), torch.float32)
        cache["v_scale_pages"] = z((L, p, ps, kv), torch.float32)
    return cache


def paged_info(cfg: ArchConfig, cache_len: int, page_size: int):
    """Incremental paging of the decoder self-attention ring; prefix
    sharing is off: the dense per-lane cross-attention caches (xk/xv) are
    lane state the prefix cache cannot share, so a 'hit' would still need
    a full encoder pass."""
    w = -(-cache_len // page_size)
    return {"pages_per_lane": w, "capacity": w * page_size,
            "alloc": "incremental", "prefix_sharing": False}


def cache_splice_paged(cfg: ArchConfig, cache, row, slot: int, pages,
                       page_size: int):
    """Splice a prefilled B=1 cache ``row`` into lane ``slot`` (an int or
    a device index, see ``common.lane_index``) of a paged ``cache``, in
    place: dense xk/xv land in the lane's row; the first
    ``len(pages)`` self-attention KV blocks go to the given pool pages
    (bskd pages reshape directly: the seq axis already leads) and the
    lane's table row is rewritten."""
    n = pages.shape[0]
    ps = page_size
    table = cache["page_table"]
    pages = pages.to(device=table.device, dtype=torch.long)
    lane = cm.lane_index(slot, table.device)
    for key in ("xk", "xv"):
        cm.splice_lane(cache[key], row[key], lane)
    for key in ("k", "v"):
        src = row[key][:, 0, :n * ps]                  # (L, n*ps, KV, D)
        L = src.shape[0]
        pool = cache[key + "_pages"]
        pool[:, pages] = src.reshape(L, n, ps, *src.shape[2:]).to(pool.dtype)
        skey = key + "_scale"
        if skey in row:
            ssrc = row[skey][:, 0, :n * ps]            # (L, n*ps, KV)
            cache[skey + "_pages"][:, pages] = \
                ssrc.reshape(L, n, ps, ssrc.shape[2])
    cm.set_table_row(table, lane, pages)
    return cache


def cache_to_kv_dtype(cfg: ArchConfig, cache, kv_dtype):
    """Quantize only the decoder self-attention ring; the cross-attention
    caches (xk/xv: written once at admission, read every step) stay in
    the float cache dtype ('bf16' casts every leaf)."""
    if kv_dtype is None:
        return cache
    if kv_dtype == "bf16":
        return {k: v.to(torch.bfloat16) for k, v in cache.items()}
    if kv_dtype != "int8":
        raise ValueError(f"unknown kv_dtype {kv_dtype!r}")
    kq, ks = quantize_into(cache["k"], axis=-1)
    vq, vs = quantize_into(cache["v"], axis=-1)
    return {**cache, "k": kq, "v": vq, "k_scale": ks, "v_scale": vs}


def cache_spec(cfg: ArchConfig, batch: int, cache_len: int, dtype):
    """The ring cache's leaves as ``(shape, dtype)`` tuples, and their
    logical axes (the JAX package's sharding vocabulary)."""
    L, kv, hd = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim
    se = cfg.encoder_seq
    kvax = (None, "batch", "cache_seq", "tp_kv", None)
    return ({
        "k": ((L, batch, cache_len, kv, hd), dtype),
        "v": ((L, batch, cache_len, kv, hd), dtype),
        "xk": ((L, batch, se, kv, hd), dtype),
        "xv": ((L, batch, se, kv, hd), dtype),
    }, {"k": kvax, "v": kvax,
        "xk": (None, "batch", None, "tp_kv", None),
        "xv": (None, "batch", None, "tp_kv", None)})


def cross_decode_attention(qx, xk, xv, valid_len, backend=None):
    """A decode step's cross-attention: qx (B, 1, H, D) against the
    lanes' dense xk/xv (B, S_enc, KV, D) through the unquantized ring
    decode of ``backend`` ('cuda': B6; 'ref': ``attention_decode``;
    None: by device)."""
    return cm.decode_attention_named(qx, xk, xv, valid_len, layout="bskd",
                                     backend=backend)


def _cross_decode(cfg: ArchConfig, lp, x, xk, xv, attend):
    """One token's cross-attention block: x (B, 1, d) -> x + output;
    ``attend(qx, xk, xv)`` is the decode attention."""
    b = x.shape[0]
    xn = _ln(x, lp, "x_ln")
    qx = (xn @ lp["x_wq"] + lp["x_bq"]).reshape(
        b, 1, cfg.num_heads, cfg.resolved_head_dim)
    return x + _out(cfg, lp, attend(qx, xk, xv), prefix="x_")


def decode_step(cfg: ArchConfig, params, token, cache, pos, *,
                window: int = 0):
    """token (B, 1) int; pos an int or 0-dim tensor shared by the lanes.
    Plain decode attention (``attention_decode``) for both blocks; on
    DTensor caches both take ``common.cache_attend_sharded`` ('bskd').
    Writes the ring cache in place; returns (logits (B, 1, V), cache)."""
    x = params["embed"][token]                         # (B, 1, d)
    b = x.shape[0]
    pos_t = cm.as_device_scalar(pos, x.device)
    posv = pos_t.reshape(1, 1).expand(b, 1)
    se = cache["xk"].shape[2]
    sharded = is_dtensor(cache["k"])

    def cross(qx, xk, xv):
        if sharded:
            return cm.cache_attend_sharded(qx, None, None, xk, xv, None,
                                           layout="bskd")
        return cm.attention_decode(qx, xk, xv, se, layout="bskd")
    for l, lp in enumerate(_layers(params["dec"])):
        ck, cv = cache["k"][l], cache["v"][l]
        xn = _ln(x, lp, "ln")
        q, k, v = _qkv(cfg, lp, xn, xn)
        q = cm.apply_rope(q, posv, cfg.rope_theta)
        k = cm.apply_rope(k, posv, cfg.rope_theta)
        if sharded:
            a = cm.cache_attend_sharded(q, k, v, ck, cv, pos_t, layout="bskd")
        else:
            cm.cache_write(ck, cv, k, v, pos_t, seq_axis=1)
            valid = cm.cache_valid_len(pos_t, ck.shape[1])
            a = cm.attention_decode(q, ck, cv, valid, layout="bskd")
        x = x + _out(cfg, lp, a)
        x = _cross_decode(cfg, lp, x, cache["xk"][l], cache["xv"][l], cross)
        x = x + _mlp(cfg, lp, x)
    return _logits(params, x), cache


def decode_step_batch(cfg: ArchConfig, params, token, cache, pos, *,
                      window: int = 0, attn_backend=None):
    """Lane-major decode: token (B, 1); pos (B,) per-lane positions.
    Self-attention: per-lane RoPE and ring (or page) writes, then one
    fused ragged decode-attention call per layer through the named
    backend ('bskd'; scales mark an int8 cache, ``page_table`` a paged
    one).  Cross-attention: the unquantized ring decode of the backend's
    family (B6 on the kernels, ``attention_decode`` on ``ref``) over the
    lane's dense xk/xv, every lane's valid length the encoder's.  Writes
    the cache in place; returns (logits (B, 1, V), cache)."""
    x = params["embed"][token]                         # (B, 1, d)
    b = x.shape[0]
    paged = "page_table" in cache
    pt = cache.get("page_table")
    kk, vk = ("k_pages", "v_pages") if paged else ("k", "v")
    ksk, vsk = ("k_scale_pages", "v_scale_pages") if paged \
        else ("k_scale", "v_scale")
    quantized = ksk in cache
    cap = pt.shape[1] * cache[kk].shape[2] if paged else cache[kk].shape[2]
    valid = cm.cache_valid_len(pos, cap)
    posv = pos[:, None]
    se = cache["xk"].shape[2]
    enc_valid = torch.full((b,), se, dtype=torch.int32, device=x.device)
    cross_backend = cm.flash_backend_of(attn_backend)

    def cross(qx, xk, xv):
        return cross_decode_attention(qx, xk, xv, enc_valid, cross_backend)
    for l, lp in enumerate(_layers(params["dec"])):
        ck, cv = cache[kk][l], cache[vk][l]
        xn = _ln(x, lp, "ln")
        q, k, v = _qkv(cfg, lp, xn, xn)
        q = cm.apply_rope(q, posv, cfg.rope_theta)
        k = cm.apply_rope(k, posv, cfg.rope_theta)
        kw = {"page_table": pt}
        if quantized:
            cks, cvs = cache[ksk][l], cache[vsk][l]
            if paged:
                cm.cache_write_batch_paged_q8(ck, cv, cks, cvs, pt, k, v,
                                              pos, seq_axis=1)
            else:
                cm.cache_write_batch_q8(ck, cv, cks, cvs, k, v, pos,
                                        seq_axis=1)
            kw.update(k_scale=cks, v_scale=cvs)
        elif paged:
            cm.cache_write_batch_paged(ck, cv, pt, k, v, pos, seq_axis=1)
        else:
            cm.cache_write_batch(ck, cv, k, v, pos, seq_axis=1)
        a = cm.decode_attention_named(q, ck, cv, valid, layout="bskd",
                                      backend=attn_backend, **kw)
        x = x + _out(cfg, lp, a)
        x = _cross_decode(cfg, lp, x, cache["xk"][l], cache["xv"][l], cross)
        x = x + _mlp(cfg, lp, x)
    return _logits(params, x), cache


def prefill(cfg: ArchConfig, params, tokens, cache_len: int, frames=None, *,
            window: int = 0, cache_dtype=torch.bfloat16,
            backend: Optional[str] = None):
    """Encode ``frames`` (zeros in the params' dtype when None: the
    scheduler passes none), run the full prompt through the decoder and
    return (logits (B, S, V), the cache after it): every layer's
    cross-attention K/V over the encoder output and its last
    ``cache_len`` self-attention K/V, a longer prompt rolled so that token
    t lives at slot t % cache_len.  ``backend`` names the flash attention
    backend."""
    b, s = tokens.shape
    if frames is None:
        frames = torch.zeros((b, cfg.encoder_seq, cfg.d_model),
                             dtype=params["embed"].dtype,
                             device=tokens.device)
    enc_out = encode(cfg, params, frames, backend=backend)
    x = cm.embed_lookup(params["embed"], tokens)
    cache = cm.prefill_cache(init_cache, cache_spec, cfg, b, cache_len,
                             cache_dtype, x)
    keep = min(s, cache_len)
    for l, lp in enumerate(_layers(params["dec"])):
        x, (k, v, kx, vx) = _dec_layer(cfg, lp, x, enc_out, window=window,
                                       backend=backend)
        cache["k"][l, :, :keep] = k[:, s - keep:]
        cache["v"][l, :, :keep] = v[:, s - keep:]
        cache["xk"][l] = kx
        cache["xv"][l] = vx
    if s > cache_len:
        shift = s % cache_len
        cache["k"] = torch.roll(cache["k"], shift, dims=2)
        cache["v"] = torch.roll(cache["v"], shift, dims=2)
    return _logits(params, x), cache
