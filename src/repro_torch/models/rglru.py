"""RecurrentGemma / Griffin hybrid: RG-LRU recurrent blocks + local MQA.

The port of ``repro.models.rglru`` [arXiv:2402.19427].  Layer i is local
attention iff i % attn_period == attn_period - 1 (one attention layer per
two recurrent ones for RecurrentGemma), else a gated linear recurrence
block:

    branch A: GeLU(W_a x)
    branch B: RG-LRU(conv1d_4(W_b x))
    out      = W_o (A * B)

RG-LRU:  a_t = exp(c * r_t * log sigmoid(L));  r_t, i_t input-sigmoid gates
         h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The JAX package scans the sequence with ``lax.associative_scan``; here
:func:`rg_lru` runs the same ``combine`` as a log-depth Hillis-Steele
doubling over the time axis (no cumulative product of ``a``, which
underflows within a few hundred tokens).  Decode is the one-step
recurrence with O(1) state, a ring conv buffer and window-sized KV rings
for the attention layers, which go through ``transformer.attn`` (B8 on
the card) and ``transformer.attn_decode_batch`` (B6/B7).

Layers are unrolled (the pattern is heterogeneous) and the parameters of
each kind are stacked.  As in ``models/transformer.py``, the decode steps
write the cache views in place, and ``jax.checkpoint`` becomes
``torch.utils.checkpoint`` (non-reentrant) per layer.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core.quantize import quantize_into
from repro_torch.models import common as cm
from repro_torch.models import transformer as tfm
from repro_torch.models.common import P
from repro_torch.sharding_hints import checkpoint, hint, is_dtensor

LRU_C = 8.0

# the local-attention window is a ring that wraps from token 0 BY DESIGN
# (attention only ever looks back window_size tokens), so the scheduler's
# prompt + max_new_tokens wrap guard must not reject long generations here
RING_WRAP_SAFE = True

# The scheduler captures the batched decode step once as a CUDA graph
# (runtime/scheduler.py): the recurrent blocks (rg_lru_step,
# causal_conv_step) are plain tensor work whose conv and h states are
# written in place (_rec_step), and the local-attention layers run
# transformer.attn_decode_batch, whose write position and valid length
# are computed on the device.  At 16 query heads of 256 (RecurrentGemma-9B)
# B6/B7 take the wide route: its plan and workspace are keyed per
# (device, stream, ...) and made by the capture's warm-up run, and its
# separate merge kernel takes no tickets, so a replay needs no memset.
CUDA_GRAPH_SAFE = True


def layer_kinds(cfg: ArchConfig):
    """List of 'rec' | 'attn' per layer."""
    p = cfg.attn_period
    return ["attn" if (i % p == p - 1) else "rec"
            for i in range(cfg.num_layers)]


def _counts(cfg):
    kinds = layer_kinds(cfg)
    return kinds.count("rec"), kinds.count("attn")


def param_template(cfg: ArchConfig):
    L, d = cfg.num_layers, cfg.d_model
    w = cfg.lru_width or d
    n_rec, n_attn = _counts(cfg)
    cw = cfg.conv_width
    return {
        "embed": P((cfg.vocab_size, d), ("tp_vocab", "fsdp"), "embed"),
        "final_ln": P((d,), (None,), "zeros"),
        "unembed": P((d, cfg.vocab_size), ("fsdp", "tp_vocab")),
        "rec": {
            "ln1": P((n_rec, d), (None, None), "zeros"),
            "w_a": P((n_rec, d, w), (None, "fsdp", "tp_ff")),
            "w_b": P((n_rec, d, w), (None, "fsdp", "tp_ff")),
            "conv_w": P((n_rec, cw, w), (None, None, "tp_ff")),
            "conv_b": P((n_rec, w), (None, "tp_ff"), "zeros"),
            "gate_a_w": P((n_rec, w, w), (None, "tp_ff", None)),
            "gate_a_b": P((n_rec, w), (None, "tp_ff"), "zeros"),
            "gate_x_w": P((n_rec, w, w), (None, "tp_ff", None)),
            "gate_x_b": P((n_rec, w), (None, "tp_ff"), "zeros"),
            "lam": P((n_rec, w), (None, "tp_ff"), "ones"),
            "w_out": P((n_rec, w, d), (None, "tp_ff", "fsdp")),
        },
        "attn": tfm._attn_template(cfg, n_attn),
        "mlp": tfm._mlp_template(cfg, L),
    }


def _slice(tree, i: int):
    """Layer ``i`` of a stacked kind: views into the stacked tensors."""
    return {k: w[i] for k, w in tree.items()}


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------


def _log_sigmoid(lam):
    """``F.logsigmoid(lam)``.  On a DTensor (DTensor has no sharding rule
    for its backward) in a ``compat.shard_map`` body on each rank's
    shard of lam's ``tp_ff`` split: the function is elementwise, so the
    gradient keeps lam's placement."""
    if not is_dtensor(lam):
        return F.logsigmoid(lam)
    from repro_torch.launch.compat import shard_map
    from repro_torch.sharding_hints import logical_to_spec
    spec = logical_to_spec(("tp_ff",), shape=lam.shape)
    fn = shard_map(F.logsigmoid, mesh=lam.device_mesh, in_specs=(spec,),
                   out_specs=spec, in_grad_specs=(spec,))
    return fn(lam)


def _gate(x, w, b):
    """sigmoid(x @ w + b).  On DTensors the product, partial over the
    split width, is hinted to the width split before the bias meets it
    (torch 2.11's DTensor cannot turn the split bias into a partial)."""
    y = x @ w
    y = hint(y, *(("batch", "seq", "ff") if y.ndim == 3 else ("batch", "ff")))
    return torch.sigmoid(y + b)


def _log_a(lp, x):
    """x: (..., w) pre-activation input; returns (log_a, input_gate)."""
    r = _gate(x, lp["gate_a_w"], lp["gate_a_b"])
    i = _gate(x, lp["gate_x_w"], lp["gate_x_b"])
    log_a = LRU_C * r.float() * _log_sigmoid(lp["lam"].float())
    return log_a, i


def _gated(a, gate_i, x):
    """sqrt(1 - a^2) * (i * x), in fp32."""
    return torch.sqrt(torch.clamp(1.0 - torch.square(a), 1e-12, 1.0)) * \
        (gate_i.float() * x.float())


def linear_scan(a, b):
    """h_t = a_t h_{t-1} + b_t from h_{-1} = 0 along axis 1: the JAX
    package's ``associative_scan`` with ``combine((a1, b1), (a2, b2)) =
    (a1 a2, a2 b1 + b2)``, as a Hillis-Steele doubling.  Step d combines
    each element with the one d places before it, so after ceil(log2 T)
    steps element t holds the fold of elements 0..t.  The products of
    ``a`` run over at most the span of one step, and an underflow to 0
    only drops terms that small."""
    t = a.shape[1]
    d = 1
    while d < t:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], dim=1)
        d *= 2
    return b


def rg_lru(lp, x, h0=None):
    """x: (B, T, w).  Returns (y (B, T, w) in x's dtype, h_last (B, w)
    fp32)."""
    log_a, gate_i = _log_a(lp, x)
    a = torch.exp(log_a)                                  # (B,T,w) in (0,1)
    gated = _gated(a, gate_i, x)
    if h0 is not None:
        # fold the incoming state in as a virtual step 0
        a = torch.cat([torch.ones_like(a[:, :1]), a], dim=1)
        gated = torch.cat([h0[:, None].float(), gated], dim=1)
    h = linear_scan(a, gated)
    if h0 is not None:
        h = h[:, 1:]
    return h.to(x.dtype), h[:, -1]


def rg_lru_step(lp, x, h):
    """x: (B, w); h: (B, w) fp32.  Returns (y in x's dtype, new h)."""
    log_a, gate_i = _log_a(lp, x)
    a = torch.exp(log_a)
    h_new = a * h + _gated(a, gate_i, x)
    return h_new.to(x.dtype), h_new


def causal_conv(lp, x, state=None):
    """Depthwise causal conv, width cw. x: (B, T, w); state: (B, cw-1, w)
    holds the inputs before x (zeros if None).  Returns (y, the new
    state)."""
    cw = lp["conv_w"].shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], cw - 1, x.shape[-1]),
                            dtype=x.dtype, device=x.device)
    xp = torch.cat([state.to(x.dtype), x], dim=1)
    t = x.shape[1]
    y = sum(xp[:, i:i + t] * lp["conv_w"][i] for i in range(cw)) \
        + lp["conv_b"]
    return y, xp[:, -(cw - 1):]


def causal_conv_step(lp, x, state):
    """x: (B, w); state: (B, cw-1, w) holds the previous cw-1 inputs."""
    cw = lp["conv_w"].shape[0]
    xp = torch.cat([state.to(x.dtype), x[:, None]], dim=1)
    y = sum(xp[:, i] * lp["conv_w"][i] for i in range(cw)) + lp["conv_b"]
    return y, xp[:, 1:]


def rec_block(cfg: ArchConfig, lp, x, conv_state=None, h_state=None):
    """The Griffin recurrent block. x: (B, T, d).  Returns (output, conv
    state, h state)."""
    xn = cm.rms_norm(x, lp["ln1"], cfg.norm_eps)
    a = cm.gelu(hint(xn @ lp["w_a"], "batch", "seq", "ff"))
    bpre = hint(xn @ lp["w_b"], "batch", "seq", "ff")
    bconv, conv_state = causal_conv(lp, bpre, conv_state)
    b, h_state = rg_lru(lp, bconv, h_state)
    return hint((a * b) @ lp["w_out"], "batch", "seq", "embed"), \
        conv_state, h_state


def rec_block_step(cfg: ArchConfig, lp, x, conv_state, h_state):
    """x: (B, d) one token."""
    xn = cm.rms_norm(x, lp["ln1"], cfg.norm_eps)
    a = cm.gelu(xn @ lp["w_a"])
    bconv, conv_state = causal_conv_step(lp, xn @ lp["w_b"], conv_state)
    b, h_state = rg_lru_step(lp, bconv, h_state)
    return (a * b) @ lp["w_out"], conv_state, h_state


def _logits(cfg: ArchConfig, params, x):
    x = cm.rms_norm(x, params["final_ln"], cfg.norm_eps)
    return hint(x @ params["unembed"], "batch", "seq", "vocab_act")


# ---------------------------------------------------------------------------
# Model API (layers unrolled; params indexed per kind)
# ---------------------------------------------------------------------------


def _block(cfg: ArchConfig, kind, lp, mp, x, backend):
    if kind == "rec":
        x = x + rec_block(cfg, lp, x)[0]
    else:
        x = x + tfm.attn(cfg, lp, x, window=cfg.local_window,
                         backend=backend)[0]
    return x + tfm.mlp(cfg, mp, x)


def forward(cfg: ArchConfig, params, tokens, *, window: int = 0,
            remat: bool = True, backend: Optional[str] = None):
    """tokens (B, S) -> logits (B, S, V).  The local window comes from the
    config (``window`` is accepted for API parity).  With ``remat`` and
    grad on, each layer keeps only its input for the backward and runs
    again there (``jax.checkpoint`` in the JAX package).  The stacked
    weights are unbound once, so their gradients are stacked once."""
    del window
    x = cm.embed_lookup(params["embed"], tokens)
    stacks = {n: {k: w.unbind(0) for k, w in params[n].items()}
              for n in ("rec", "attn", "mlp")}
    for kind, i, li in _layers(cfg):
        lp = _slice(stacks[kind], i)
        mp = _slice(stacks["mlp"], li)
        if remat and torch.is_grad_enabled():
            x = checkpoint(_block, cfg, kind, lp, mp, x, backend,
                           use_reentrant=False)
        else:
            x = _block(cfg, kind, lp, mp, x, backend)
    return _logits(cfg, params, x)


def loss_fn(cfg: ArchConfig, params, batch, *, window: int = 0,
            backend: Optional[str] = None):
    """Next-token cross entropy of ``batch`` {"tokens", "labels"} (B, S):
    (loss, {"loss": loss})."""
    logits = forward(cfg, params, batch["tokens"], backend=backend)
    loss = cm.softmax_xent(logits[:, :-1], batch["labels"][:, 1:])
    return loss, {"loss": loss}


def _window_len(cfg: ArchConfig, cache_len: int) -> int:
    return min(cache_len, cfg.local_window)


def init_cache(cfg: ArchConfig, batch: int, cache_len: int,
               dtype=torch.bfloat16, kv_dtype=None, page_size=None,
               num_pages=None, device="cpu"):
    """The recurrent state, h (n_rec, B, w) fp32 and conv (n_rec, B, cw-1,
    w) in ``dtype``, and the local-attention windows: (n_attn, B, KV,
    wlen, D) rings, wlen = min(cache_len, local_window), int8 with
    (n_attn, B, KV, wlen) fp32 scales; with ``page_size`` the pools
    (n_attn, P, KV, ps, D) behind a (B, wlen / ps) ``page_table``."""
    n_rec, n_attn = _counts(cfg)
    w = cfg.lru_width or cfg.d_model
    wlen = _window_len(cfg, cache_len)
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    kvd = tfm.kv_cache_dtype(dtype, kv_dtype)
    z = lambda shape, dt=kvd: torch.zeros(shape, dtype=dt, device=device)
    cache = {"h": z((n_rec, batch, w), torch.float32),
             "conv": z((n_rec, batch, cfg.conv_width - 1, w), dtype)}
    if page_size is None:
        cache["k"] = z((n_attn, batch, kv, wlen, hd))
        cache["v"] = z((n_attn, batch, kv, wlen, hd))
        if kv_dtype == "int8":
            cache["k_scale"] = z((n_attn, batch, kv, wlen), torch.float32)
            cache["v_scale"] = z((n_attn, batch, kv, wlen), torch.float32)
        return cache
    # paged local-attention windows: the recurrent h/conv state stays
    # dense per lane (it IS the recurrence, one slot per lane)
    wp = paged_info(cfg, cache_len, page_size)["pages_per_lane"]
    p = num_pages if num_pages is not None else 1 + batch * wp
    cache["k_pages"] = z((n_attn, p, kv, page_size, hd))
    cache["v_pages"] = z((n_attn, p, kv, page_size, hd))
    cache["page_table"] = z((batch, wp), torch.int32)
    if kv_dtype == "int8":
        cache["k_scale_pages"] = z((n_attn, p, kv, page_size), torch.float32)
        cache["v_scale_pages"] = z((n_attn, p, kv, page_size), torch.float32)
    return cache


def paged_info(cfg: ArchConfig, cache_len: int, page_size: int):
    """Windowed attention pages: every lane owns its full window for its
    whole lifetime (the ring wraps, so pages are rewritten for ever), so
    allocation is up-front ('full') and prefix sharing is off (a shared
    page would be split on the first wrap anyway)."""
    wlen = _window_len(cfg, cache_len)
    if wlen % page_size:
        raise ValueError(f"page_size {page_size} must divide attention "
                         f"window {wlen} for the rglru family")
    return {"pages_per_lane": wlen // page_size, "capacity": wlen,
            "alloc": "full", "prefix_sharing": False}


def cache_splice_paged(cfg: ArchConfig, cache, row, slot: int, pages,
                       page_size: int):
    """Splice a prefilled B=1 cache ``row`` into lane ``slot`` (an int or
    a device index, see ``common.lane_index``) of a paged ``cache``, in
    place: the dense h/conv state lands in the lane's row
    and the window's KV ring is scattered across the lane's ``pages``
    (all of its pages: the ring's wrap alignment is kept, since paged
    writes also wrap at W * ps == wlen)."""
    n = pages.shape[0]
    ps = page_size
    table = cache["page_table"]
    if n != table.shape[1]:
        raise ValueError(f"cache_splice_paged: {n} pages for a lane of "
                         f"{table.shape[1]} (full allocation)")
    pages = pages.to(device=table.device, dtype=torch.long)
    lane = cm.lane_index(slot, table.device)
    cm.splice_lane(cache["h"], row["h"], lane)
    cm.splice_lane(cache["conv"], row["conv"], lane)
    for key in ("k", "v"):
        src = row[key][:, 0]                           # (n_attn, KV, wlen, D)
        na, kv = src.shape[0], src.shape[1]
        pool = cache[key + "_pages"]
        pool[:, pages] = src.reshape(na, kv, n, ps, -1).transpose(1, 2) \
            .to(pool.dtype)
        skey = key + "_scale"
        if skey in row:
            ssrc = row[skey][:, 0]                     # (n_attn, KV, wlen)
            cache[skey + "_pages"][:, pages] = \
                ssrc.reshape(na, kv, n, ps).transpose(1, 2)
    cm.set_table_row(table, lane, pages)
    return cache


def cache_to_kv_dtype(cfg: ArchConfig, cache, kv_dtype):
    """Quantize only the local-attention KV windows; the recurrent state
    ('h', fp32) and the conv ring buffer are untouched: they are the
    recurrence, not a cache, and rounding them would compound error at
    every step."""
    if kv_dtype is None:
        return cache
    if kv_dtype == "bf16":
        return {**cache, "k": cache["k"].to(torch.bfloat16),
                "v": cache["v"].to(torch.bfloat16)}
    if kv_dtype != "int8":
        raise ValueError(f"unknown kv_dtype {kv_dtype!r}")
    kq, ks = quantize_into(cache["k"], axis=-1)
    vq, vs = quantize_into(cache["v"], axis=-1)
    return {**cache, "k": kq, "v": vq, "k_scale": ks, "v_scale": vs}


def cache_spec(cfg: ArchConfig, batch: int, cache_len: int, dtype):
    """The ring cache's leaves as ``(shape, dtype)`` tuples, and their
    logical axes (the JAX package's sharding vocabulary)."""
    n_rec, n_attn = _counts(cfg)
    w = cfg.lru_width or cfg.d_model
    wlen = _window_len(cfg, cache_len)
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    return ({
        "h": ((n_rec, batch, w), torch.float32),
        "conv": ((n_rec, batch, cfg.conv_width - 1, w), dtype),
        "k": ((n_attn, batch, kv, wlen, hd), dtype),
        "v": ((n_attn, batch, kv, wlen, hd), dtype),
    }, {
        "h": (None, "batch", "ff"),
        "conv": (None, "batch", None, "ff"),
        "k": (None, "batch", "tp_kv", "cache_seq", None),
        "v": (None, "batch", "tp_kv", "cache_seq", None),
    })


def _layers(cfg):
    """(kind, index within the kind, layer index) per layer."""
    ri = ai = 0
    for li, kind in enumerate(layer_kinds(cfg)):
        if kind == "rec":
            yield kind, ri, li
            ri += 1
        else:
            yield kind, ai, li
            ai += 1


def _rec_step(cfg, params, cache, ri, x):
    """One recurrent block on one token; its state views updated in
    place."""
    conv, h = cache["conv"][ri], cache["h"][ri]
    a, cst, hst = rec_block_step(cfg, _slice(params["rec"], ri), x, conv, h)
    conv.copy_(cst)
    h.copy_(hst)
    return x + a


def decode_step(cfg: ArchConfig, params, token, cache, pos, *,
                window: int = 0):
    """token (B, 1) int; pos an int or 0-dim tensor shared by the lanes.
    Writes the ring cache in place; returns (logits (B, 1, V), cache)."""
    del window
    x = params["embed"][token[:, 0]]                      # (B, d)
    for kind, i, li in _layers(cfg):
        if kind == "rec":
            x = _rec_step(cfg, params, cache, i, x)
        else:
            x = x + tfm.attn_decode(
                cfg, _slice(params["attn"], i), x[:, None], cache["k"][i],
                cache["v"][i], pos, window=cfg.local_window)[:, 0]
        x = x + tfm.mlp(cfg, _slice(params["mlp"], li), x)
    return _logits(cfg, params, x)[:, None], cache


def decode_step_batch(cfg: ArchConfig, params, tokens, cache, pos, *,
                      window: int = 0, attn_backend=None):
    """Lane-major decode: tokens (B, 1); pos (B,) per lane.  The recurrent
    blocks are batched as they are; the local-attention layers take the
    fused ragged decode attention (per-lane RoPE positions and ring
    writes).  A paged cache (``page_table``) indexes per-layer page pools
    with one lane page table shared by the layers; an int8 one
    (``k_scale``/``k_scale_pages``) the q8 attention.  Writes the cache in
    place; returns (logits (B, 1, V), cache)."""
    del window
    x = params["embed"][tokens[:, 0]]
    paged = "page_table" in cache
    kk, vk = ("k_pages", "v_pages") if paged else ("k", "v")
    ksk, vsk = ("k_scale_pages", "v_scale_pages") if paged \
        else ("k_scale", "v_scale")
    pt = cache.get("page_table")
    quantized = ksk in cache
    for kind, i, li in _layers(cfg):
        if kind == "rec":
            x = _rec_step(cfg, params, cache, i, x)
        else:
            scales = dict(cks=cache[ksk][i], cvs=cache[vsk][i]) \
                if quantized else {}
            x = x + tfm.attn_decode_batch(
                cfg, _slice(params["attn"], i), x[:, None], cache[kk][i],
                cache[vk][i], pos, window=cfg.local_window,
                backend=attn_backend, page_table=pt, **scales)[:, 0]
        x = x + tfm.mlp(cfg, _slice(params["mlp"], li), x)
    return _logits(cfg, params, x)[:, None], cache


def prefill(cfg: ArchConfig, params, tokens, cache_len: int, *,
            window: int = 0, cache_dtype=torch.bfloat16,
            backend: Optional[str] = None):
    """Run the full prompt: (logits (B, S, V), the cache after it).  Each
    attention layer keeps its last wlen = min(cache_len, local_window)
    keys and values; a prompt longer than wlen is rolled so that token t
    lives at slot t % wlen.  ``backend`` names the flash attention
    backend (see ``transformer.attn``)."""
    del window
    b, s = tokens.shape
    x = cm.embed_lookup(params["embed"], tokens)
    cache = cm.prefill_cache(init_cache, cache_spec, cfg, b, cache_len,
                             cache_dtype, x)
    wlen = _window_len(cfg, cache_len)
    keep = min(s, wlen)
    for kind, i, li in _layers(cfg):
        if kind == "rec":
            a, cst, hst = rec_block(cfg, _slice(params["rec"], i), x)
            cache["conv"][i] = cst
            cache["h"][i] = hst
        else:
            a, (k, v) = tfm.attn(cfg, _slice(params["attn"], i), x,
                                 window=cfg.local_window, backend=backend)
            # (B, S, KV, D) -> bksd (B, KV, S, D)
            cache["k"][i, :, :, :keep] = k[:, s - keep:].transpose(1, 2)
            cache["v"][i, :, :, :keep] = v[:, s - keep:].transpose(1, 2)
        x = x + a
        x = x + tfm.mlp(cfg, _slice(params["mlp"], li), x)
    if s > wlen:
        cache["k"] = torch.roll(cache["k"], s % wlen, dims=3)
        cache["v"] = torch.roll(cache["v"], s % wlen, dims=3)
    return _logits(cfg, params, x), cache
