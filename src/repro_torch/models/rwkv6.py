"""RWKV-6 "Finch": attention-free RNN with data-dependent decay.

The port of ``repro.models.rwkv6`` [arXiv:2404.05892].  Matrix-valued
per-head state S in R^{N x N}:

    S_t   = diag(w_t) S_{t-1} + k_t v_t^T
    out_t = r_t . (S_{t-1} + diag(u) k_t v_t^T)

with token-shift "ddlerp" low-rank mixing producing r/k/v/w/g per token
and the decay w_t itself data-dependent.

Prefill and training run the exact chunked scan (:func:`wkv_chunked`,
16-token chunks, pairwise decays clipped to [-60, 0]); decode is the O(1)
recurrence (:func:`wkv_step`).  The chunked WKV goes through
:func:`wkv_named`, whose ``cuda`` backend is the kernel B10
(``kernels/csrc/rwkv6_chunk.cu``) when no gradient is taken.

As in ``models/transformer.py``, the JAX package's ``lax.scan`` over
layers becomes a Python loop over views ``params["layers"][k][l]``, the
decode step writes the (L, B, ...) state views in place (the scheduler's
per-lane loop drops the returned cache), and ``jax.checkpoint`` per layer
becomes ``torch.utils.checkpoint`` (non-reentrant).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import common as cm
from repro_torch.models.common import P
from repro_torch.launch import op_costs
from repro_torch.sharding_hints import checkpoint, hint, is_dtensor

# O(1) matrix state, no KV ring at all: generation length is unbounded by
# cache_len, so the scheduler's ring-wrap guard does not apply
RING_WRAP_SAFE = True

# The scheduler captures the batched decode step once as a CUDA graph
# (runtime/scheduler.py): decode_step_batch -> decode_step and wkv_step
# read no device value on the host, no shape depends on data, and the
# state (wkv, shift_tm, shift_cm) is written in place with ``copy_``.
# The step launches none of our kernels: B10 runs only in prefill, which
# a captured admission holds (one graph per prefill bucket); B10's kept
# records buffer is never replaced, so every such graph may hold it.
CUDA_GRAPH_SAFE = True

MIX_LORA = 32     # rank of the ddlerp mixing lora (5 targets: w,k,v,r,g)
DECAY_LORA = 64   # rank of the decay lora
CHUNK = 16        # intra-chunk length for the parallel scan
NEG_BIG = -60.0   # floor of the intra-chunk decay exponents


def param_template(cfg: ArchConfig):
    L, d, f = cfg.num_layers, cfg.d_model, cfg.d_ff
    H = cfg.d_model // cfg.rwkv_head_dim
    N = cfg.rwkv_head_dim
    return {
        "embed": P((cfg.vocab_size, d), ("tp_vocab", "fsdp"), "embed"),
        "final_ln": P((d,), (None,), "zeros"),
        "unembed": P((d, cfg.vocab_size), ("fsdp", "tp_vocab")),
        "layers": {
            "ln1": P((L, d), (None, None), "zeros"),
            "ln2": P((L, d), (None, None), "zeros"),
            # --- time mix (ddlerp) ---
            "maa_x": P((L, d), (None, None), "zeros"),
            "maa_base": P((L, 5, d), (None, None, None), "zeros"),
            "maa_w1": P((L, d, 5 * MIX_LORA), (None, "fsdp", None)),
            "maa_w2": P((L, 5, MIX_LORA, d), (None, None, None, "fsdp")),
            "decay_base": P((L, d), (None, None), "zeros"),
            "decay_w1": P((L, d, DECAY_LORA), (None, "fsdp", None)),
            "decay_w2": P((L, DECAY_LORA, d), (None, None, "fsdp")),
            "bonus": P((L, H, N), (None, "tp_heads", None)),
            "wr": P((L, d, d), (None, "fsdp", "tp_heads")),
            "wk": P((L, d, d), (None, "fsdp", "tp_heads")),
            "wv": P((L, d, d), (None, "fsdp", "tp_heads")),
            "wg": P((L, d, d), (None, "fsdp", "tp_heads")),
            "wo": P((L, d, d), (None, "tp_heads", "fsdp")),
            "gn_w": P((L, d), (None, None), "ones"),
            "gn_b": P((L, d), (None, None), "zeros"),
            # --- channel mix ---
            "cm_maa_k": P((L, d), (None, None), "zeros"),
            "cm_maa_r": P((L, d), (None, None), "zeros"),
            "cm_wk": P((L, d, f), (None, "fsdp", "tp_ff")),
            "cm_wv": P((L, f, d), (None, "tp_ff", "fsdp")),
            "cm_wr": P((L, d, d), (None, "fsdp", "tp_heads")),
        },
    }


def _layer(params, l: int):
    """Layer ``l``'s parameters: views into the stacked tensors."""
    return {k: w[l] for k, w in params["layers"].items()}


# ---------------------------------------------------------------------------
# WKV scans (the plain versions: tests, the ``ref`` backend, training)
# ---------------------------------------------------------------------------


def _acc_dtype(dtype):
    """The arithmetic type: fp32, or fp64 for fp64 inputs (an exact
    evaluation of the same function, for checks)."""
    return torch.promote_types(dtype, torch.float32)


def wkv_chunked(r, k, v, w, u, s0=None, chunk: int = CHUNK):
    """Exact chunked RWKV6 linear attention.

    r, k, v, w: (B, T, H, N) with w in (0, 1]; u: (H, N); s0: the
    incoming state (B, H, N, N) fp32 or None (zeros).  T is padded to a
    multiple of ``chunk`` with k = v = r = 0 and w = 1, which leaves the
    state unchanged.  Returns out (B, T, H, N) in r's dtype and the final
    state (B, H, N, N) fp32 (fp64 for fp64 inputs).
    """
    b, t, h, n = r.shape
    pad = (-t) % chunk
    if pad:
        zpad = lambda x: F.pad(x, (0, 0, 0, 0, 0, pad))
        r, k, v = zpad(r), zpad(k), zpad(v)
        w = F.pad(w, (0, 0, 0, 0, 0, pad), value=1.0)
    nc = (t + pad) // chunk
    rs = lambda x: x.reshape(b, nc, chunk, h, n)
    rc, kc, vc, wc = rs(r), rs(k), rs(v), rs(w)
    acc = _acc_dtype(r.dtype)
    s = torch.zeros((b, h, n, n), dtype=acc, device=r.device) \
        if s0 is None else s0
    ii = torch.arange(chunk, device=r.device)
    lower = (ii[:, None] > ii[None, :]).to(acc)[None, :, :, None, None]
    uf = u.to(acc)
    # shapes only with no gradient (the dry run): two chunks stand for all,
    # the other chunks' outputs held (op_costs.trips)
    meta = r.is_meta and not (torch.is_grad_enabled() and r.requires_grad)
    chunks = op_costs.trips(nc, meta)
    for c in chunks:
        rr, kk, vv, ww = (x[:, c].to(acc) for x in (rc, kc, vc, wc))
        lw = torch.log(torch.clamp(ww, 1e-26, 1.0))       # (B,C,H,N) <= 0
        cum = torch.cumsum(lw, dim=1)
        qdec = torch.exp(cum - lw)                        # decay before token i
        cum_last = cum[:, -1:]                            # (B,1,H,N)
        kdec = kk * torch.exp(cum_last - cum)             # decay to chunk end
        # intra-chunk pairwise decays (B,C,C,H,N); the clip kills the inf
        # that exp() would produce on the masked upper triangle
        diff = (cum - lw)[:, :, None] - cum[:, None, :]
        fac = torch.exp(torch.clamp(diff, NEG_BIG, 0.0)) * lower
        att = (rr[:, :, None] * kk[:, None, :] * fac).sum(-1)   # (B,i,j,H)
        out = torch.einsum("bijh,bjhn->bihn", att, vv)
        bonus = (rr * kk * uf).sum(-1)                    # current token
        out = out + bonus[..., None] * vv
        out = out + torch.einsum("bihn,bhnm->bihm", rr * qdec, s)
        s = s * torch.exp(cum_last[:, 0])[..., None] + \
            torch.einsum("bjhn,bjhm->bhnm", kdec, vv)
        chunks.keep(out)
    out = torch.stack(chunks.outs, 1).reshape(b, nc * chunk, h, n)[:, :t]
    return out.to(r.dtype), s


def wkv_step(r, k, v, w, u, s):
    """One-token recurrence. r, k, v, w: (B, H, N); s: (B, H, N, N) fp32."""
    r, k, v, w = (x.to(_acc_dtype(x.dtype)) for x in (r, k, v, w))
    kv = k[..., :, None] * v[..., None, :]                # (B,H,N,N)
    out = torch.einsum("bhn,bhnm->bhm", r, s + u[..., None] * kv)
    return out, s * w[..., None] + kv


def wkv_scan(r, k, v, w, u, s0=None):
    """Token-by-token reference (the oracle of :func:`wkv_chunked`)."""
    b, t, h, n = r.shape
    s = torch.zeros((b, h, n, n), dtype=_acc_dtype(r.dtype), device=r.device) \
        if s0 is None else s0
    outs = []
    for i in range(t):
        out, s = wkv_step(r[:, i], k[:, i], v[:, i], w[:, i], u, s)
        outs.append(out)
    return torch.stack(outs, 1).to(r.dtype), s


def wkv_named(r, k, v, w, u, *, s0=None, backend: Optional[str] = None):
    """The chunked WKV through a named backend: 'ref' (:func:`wkv_chunked`),
    'cuda' (B10, ``kernels.ops.rwkv6_chunked``), or None/'auto' (cuda on
    a CUDA tensor, ref on a CPU one).

    With grad on and an input that requires it, every backend
    differentiates the plain :func:`wkv_chunked` by autograd: B10 has no
    backward, as the TPU kernel has no VJP, and the JAX package trains
    through its jnp chunked scan too.  B10 starts from a zero state, as
    the TPU kernel does, so 'cuda' raises on a non-None ``s0``.  Where
    None/'auto' resolves to 'ref' (no card) and B10 would run, a memory
    count charges what B10 allocates (``launch.memory.rwkv6_chunked``).
    """
    if is_dtensor(r):
        return _wkv_sharded(r, k, v, w, u, s0=s0, backend=backend)
    name = cm.resolve_flash_backend(backend, r.device)
    inputs = (r, k, v, w, u) + (() if s0 is None else (s0,))
    if torch.is_grad_enabled() and any(x.requires_grad for x in inputs):
        return wkv_chunked(r, k, v, w, u, s0=s0)
    if name == "ref":
        if backend in (None, "auto") and s0 is None:
            # the card would run B10: a memory count charges it
            from repro_torch.launch import memory
            return memory.rwkv6_chunked(wkv_chunked, r, k, v, w, u)
        return wkv_chunked(r, k, v, w, u, s0=s0)
    if s0 is not None:
        raise ValueError("wkv_named: the cuda backend (B10) starts from a "
                         "zero state; pass s0=None or backend='ref'")
    from repro_torch.kernels import ops as kops
    return kops.rwkv6_chunked(r, k, v, w, u)


def _wkv_sharded(r, k, v, w, u, *, s0, backend):
    """:func:`wkv_named` on DTensors: each rank runs the same backend on
    its own (batch, heads) shards, which the recurrence never mixes; u's
    gradient is a partial sum over the batch axes."""
    from torch.distributed.tensor import Partial

    from repro_torch.launch.compat import shard_map
    from repro_torch.sharding_hints import logical_to_spec, to_placements
    mesh = r.device_mesh
    xspec = logical_to_spec(("batch", None, "heads", None), shape=r.shape)
    uspec = (xspec[2], None)
    sspec = (xspec[0], xspec[2], None, None)
    batch = cm._axes_of(xspec[0])
    ugrad = tuple(Partial() if n in batch else p for n, p in zip(
        mesh.mesh_dim_names, to_placements(uspec, mesh)))

    def body(*xs):
        return wkv_named(*xs[:5], s0=xs[5] if len(xs) > 5 else None,
                         backend=backend)

    args = (r, k, v, w, u) + (() if s0 is None else (s0,))
    specs = (xspec,) * 4 + (uspec,) + (() if s0 is None else (sspec,))
    grads = (xspec,) * 4 + (ugrad,) + (() if s0 is None else (sspec,))
    fn = shard_map(body, mesh=mesh, in_specs=specs, out_specs=[xspec, sspec],
                   in_grad_specs=grads)
    return fn(*args)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _ddlerp(lp, x, sx):
    """Data-dependent token-shift mixing -> (xw, xk, xv, xr, xg)."""
    xxx = x + sx * lp["maa_x"]
    m = cm.split_heads(torch.tanh(xxx @ lp["maa_w1"]), 5, None)
    off = torch.einsum("...fr,frd->...fd", m, lp["maa_w2"])
    mix = lp["maa_base"] + off                            # (..., 5, d)
    xs = x[..., None, :] + sx[..., None, :] * mix
    return tuple(xs[..., i, :] for i in range(5))


def _decay(cfg, lp, xw):
    inner = lp["decay_base"] + torch.tanh(xw @ lp["decay_w1"]) @ lp["decay_w2"]
    return torch.exp(-torch.exp(torch.clamp(inner.float(), -20.0, 5.0)))


def _heads(cfg, x):
    return cm.split_heads(x, x.shape[-1] // cfg.rwkv_head_dim)


def _group_norm(x, w, b, eps=1e-5):
    """Per-head normalization over N with the population variance
    (``jnp.var``; torch's default is the unbiased one)."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    sh = x.shape[-2:]
    return (y * w.reshape(sh) + b.reshape(sh)).to(x.dtype)


def _rkvgwu(cfg, lp, x, sx):
    """The per-token projections of the time mix: r, k, v, w in heads,
    the gate g, and the bonus u (H, N)."""
    xw, xk, xv, xr, xg = _ddlerp(lp, x, sx)
    r = _heads(cfg, xr @ lp["wr"])
    k = _heads(cfg, xk @ lp["wk"])
    v = _heads(cfg, xv @ lp["wv"])
    g = F.silu(xg @ lp["wg"])
    w = _heads(cfg, _decay(cfg, lp, xw))
    u = _heads(cfg, lp["bonus"].reshape(-1))
    return r, k, v, w, g, u


def time_mix(cfg: ArchConfig, lp, x, shift_state=None, wkv_state=None,
             use_chunked=True, backend: Optional[str] = None):
    """x: (B, T, d).  shift_state: (B, d) last token of the previous
    segment.  Returns (output, the shift state x[:, -1], the wkv state);
    the chunked WKV goes through :func:`wkv_named` with ``backend``."""
    b, t, d = x.shape
    prev = torch.zeros((b, 1, d), dtype=x.dtype, device=x.device) \
        if shift_state is None else shift_state[:, None].to(x.dtype)
    x_prev = torch.cat([prev, x[:, :-1]], dim=1)
    r, k, v, w, g, u = _rkvgwu(cfg, lp, x, x_prev - x)
    r = hint(r, "batch", "seq", "heads", None)
    if use_chunked:
        out, s = wkv_named(r, k, v, w, u, s0=wkv_state, backend=backend)
    else:
        out, s = wkv_scan(r, k, v, w, u, s0=wkv_state)
    out = _group_norm(out, lp["gn_w"], lp["gn_b"]).reshape(b, t, d)
    return (out * g) @ lp["wo"], x[:, -1], s


def time_mix_step(cfg: ArchConfig, lp, x, shift_state, wkv_state):
    """x: (B, d) one token."""
    r, k, v, w, g, u = _rkvgwu(cfg, lp, x, shift_state.to(x.dtype) - x)
    out, s = wkv_step(r, k, v, w, u, wkv_state)
    out = _group_norm(out, lp["gn_w"], lp["gn_b"]).reshape(x.shape)
    return (out.to(x.dtype) * g) @ lp["wo"], x, s


def channel_mix(cfg: ArchConfig, lp, x, shift_state=None):
    """x: (B, T, d) (with the previous segment's last token as
    ``shift_state``, or zeros) or (B, d) one token after ``shift_state``.
    Returns (output, the new shift state)."""
    b = x.shape[0]
    if x.ndim == 3:
        prev = torch.zeros((b, 1, x.shape[-1]), dtype=x.dtype,
                           device=x.device) if shift_state is None \
            else shift_state[:, None].to(x.dtype)
        x_prev = torch.cat([prev, x[:, :-1]], dim=1)
        new_shift = x[:, -1]
    else:
        x_prev = shift_state.to(x.dtype)
        new_shift = x
    sx = x_prev - x
    xk = x + sx * lp["cm_maa_k"]
    xr = x + sx * lp["cm_maa_r"]
    k = torch.square(torch.relu(hint(xk @ lp["cm_wk"], "batch", "seq",
                                     "ff")))
    return torch.sigmoid(xr @ lp["cm_wr"]) * (k @ lp["cm_wv"]), new_shift


def _logits(cfg: ArchConfig, params, x):
    x = cm.rms_norm(x, params["final_ln"], cfg.norm_eps)
    return hint(x @ params["unembed"], "batch", "seq", "vocab_act")


# ---------------------------------------------------------------------------
# Model API
# ---------------------------------------------------------------------------


def _block(cfg: ArchConfig, lp, x, backend):
    a, _, _ = time_mix(cfg, lp, cm.rms_norm(x, lp["ln1"], cfg.norm_eps),
                       backend=backend)
    x = x + a
    c, _ = channel_mix(cfg, lp, cm.rms_norm(x, lp["ln2"], cfg.norm_eps))
    return x + c


def forward(cfg: ArchConfig, params, tokens, *, window: int = 0,
            remat: bool = True, backend: Optional[str] = None):
    """tokens (B, S) -> logits (B, S, V).  With ``remat`` and grad on,
    each layer keeps only its input for the backward and runs again
    there (``jax.checkpoint`` in the JAX package).  ``window`` is
    accepted for API parity: the model is attention-free."""
    del window
    x = cm.embed_lookup(params["embed"], tokens)
    layers = {k: w.unbind(0) for k, w in params["layers"].items()}
    for l in range(cfg.num_layers):
        lp = {k: w[l] for k, w in layers.items()}
        if remat and torch.is_grad_enabled():
            x = checkpoint(_block, cfg, lp, x, backend, use_reentrant=False)
        else:
            x = _block(cfg, lp, x, backend)
    return _logits(cfg, params, x)


def loss_fn(cfg: ArchConfig, params, batch, *, window: int = 0,
            backend: Optional[str] = None):
    """Next-token cross entropy of ``batch`` {"tokens", "labels"} (B, S):
    (loss, {"loss": loss})."""
    logits = forward(cfg, params, batch["tokens"], backend=backend)
    loss = cm.softmax_xent(logits[:, :-1], batch["labels"][:, 1:])
    return loss, {"loss": loss}


def init_cache(cfg: ArchConfig, batch: int, cache_len: int,
               dtype=torch.bfloat16, kv_dtype=None, page_size=None,
               num_pages=None, device="cpu"):
    """The O(1) recurrent state: wkv (L, B, H, N, N) fp32 and the two
    shift states (L, B, d) in ``dtype``.  ``cache_len``, ``kv_dtype`` and
    the page arguments are accepted for API parity: there is no KV cache
    to size, quantize or page."""
    del cache_len, kv_dtype, page_size, num_pages
    L, d = cfg.num_layers, cfg.d_model
    H, N = d // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    return {
        "wkv": torch.zeros((L, batch, H, N, N), dtype=torch.float32,
                           device=device),
        "shift_tm": torch.zeros((L, batch, d), dtype=dtype, device=device),
        "shift_cm": torch.zeros((L, batch, d), dtype=dtype, device=device),
    }


def cache_to_kv_dtype(cfg: ArchConfig, cache, kv_dtype):
    """State passthrough: the wkv matrix state IS the recurrence (updated
    every step, fp32 by necessity), not a token cache; int8 round trips
    would compound error without bound, so kv_dtype is a no-op here."""
    del kv_dtype
    return cache


def cache_spec(cfg: ArchConfig, batch: int, cache_len: int, dtype):
    """The recurrent state's leaves as ``(shape, dtype)`` tuples
    (``common.meta_tree`` makes them meta tensors), and their logical
    axes; ``cache_len`` does not size it."""
    del cache_len
    L, d = cfg.num_layers, cfg.d_model
    H, N = d // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    return ({
        "wkv": ((L, batch, H, N, N), torch.float32),
        "shift_tm": ((L, batch, d), dtype),
        "shift_cm": ((L, batch, d), dtype),
    }, {
        "wkv": (None, "batch", "heads", None, None),
        "shift_tm": (None, "batch", None),
        "shift_cm": (None, "batch", None),
    })


def decode_step(cfg: ArchConfig, params, token, cache, pos, *,
                window: int = 0):
    """token (B, 1) int.  Advances the state views of ``cache`` in place
    and returns (logits (B, 1, V), cache); ``pos`` and ``window`` are
    unused (the recurrence is position-free)."""
    del pos, window
    x = params["embed"][token[:, 0]]                      # (B, d)
    for l in range(cfg.num_layers):
        lp = _layer(params, l)
        wkv, stm, scm = (cache[k][l] for k in ("wkv", "shift_tm", "shift_cm"))
        a, new_tm, new_wkv = time_mix_step(
            cfg, lp, cm.rms_norm(x, lp["ln1"], cfg.norm_eps), stm, wkv)
        x = x + a
        c, new_cm = channel_mix(
            cfg, lp, cm.rms_norm(x, lp["ln2"], cfg.norm_eps), scm)
        x = x + c
        wkv.copy_(new_wkv)
        stm.copy_(new_tm)
        scm.copy_(new_cm)
    return _logits(cfg, params, x)[:, None], cache


def decode_step_batch(cfg: ArchConfig, params, tokens, cache, pos, *,
                      window: int = 0, attn_backend=None):
    """Lane-major decode for the scheduler's batched path.  The RWKV
    recurrence is position-free and :func:`decode_step` is already
    batched over lanes, so the per-lane ``pos`` vector is dropped."""
    del attn_backend
    return decode_step(cfg, params, tokens, cache, pos, window=window)


def prefill(cfg: ArchConfig, params, tokens, cache_len: int, *,
            window: int = 0, cache_dtype=torch.bfloat16,
            backend: Optional[str] = None):
    """Run the full prompt: (logits (B, S, V), the state after it).  The
    chunked WKV goes through ``backend`` (see :func:`wkv_named`)."""
    del window
    b, _ = tokens.shape
    x = cm.embed_lookup(params["embed"], tokens)
    cache = cm.prefill_cache(init_cache, cache_spec, cfg, b, cache_len,
                             cache_dtype, x)
    for l in range(cfg.num_layers):
        lp = _layer(params, l)
        a, stm, wkv = time_mix(cfg, lp,
                               cm.rms_norm(x, lp["ln1"], cfg.norm_eps),
                               backend=backend)
        x = x + a
        c, scm = channel_mix(cfg, lp, cm.rms_norm(x, lp["ln2"], cfg.norm_eps))
        x = x + c
        cache["wkv"][l] = wkv
        cache["shift_tm"][l] = stm.to(cache_dtype)
        cache["shift_cm"][l] = scm.to(cache_dtype)
    return _logits(cfg, params, x), cache
