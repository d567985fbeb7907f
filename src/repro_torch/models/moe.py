"""Mixture-of-Experts decoder (qwen3-moe, granite-moe families).

The port of ``repro.models.moe``.  Token-choice top-k routing with
sort-based capacity dispatch: tokens are argsorted by expert id into an
(E, C, d) buffer, each expert runs a dense SwiGLU over its slice, and
results are combined with the (renormalized) router weights.  Overflowing
tokens beyond capacity C are dropped (GShard/Switch semantics,
``capacity_factor`` controls the slack).  The capacity counts every token
of the call, padding and idle decode lanes included, as in the JAX
package, so both route and drop the same tokens.

Three departures in spelling, none in result:

- No host syncs on the card: expert counts are a ``scatter_add_`` (not
  ``bincount``, which reads its input's max back), the token index of
  each (token, choice) entry is an expanded ``arange`` (not
  ``repeat_interleave``), and nothing is indexed by a boolean mask.
- The combine is deterministic: the JAX ``.at[st].add`` would be float
  atomics on the card, summing in a different order on every run.  Here
  the sort is undone with its inverse permutation and each token's k
  contributions are summed in a fixed order.
- The layer loops of the serving path are the dense transformer's, with
  the MoE block passed in as its ``ffn``.

The ``shard_map`` paths of the JAX package (``moe_ffn_a2a``,
``moe_ffn_local``) fall back to ``moe_ffn_dense`` there when no mesh is
active; the port has no mesh yet, so ``moe_ffn`` is ``moe_ffn_dense``.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import common as cm
from repro_torch.models import transformer as tfm
from repro_torch.models.common import P


def param_template(cfg: ArchConfig):
    L, d, f, E = cfg.num_layers, cfg.d_model, cfg.d_ff, cfg.num_experts
    t = {
        "embed": P((cfg.vocab_size, d), ("tp_vocab", "fsdp"), "embed"),
        "final_ln": P((d,), (None,), "zeros"),
        "layers": {
            **tfm._attn_template(cfg, L),
            "ln2": P((L, d), (None, None), "zeros"),
            "router": P((L, d, E), (None, "fsdp", None)),
            "we_gate": P((L, E, d, f), (None, "experts", "fsdp", "tp_ff")),
            "we_up": P((L, E, d, f), (None, "experts", "fsdp", "tp_ff")),
            "we_down": P((L, E, f, d), (None, "experts", "tp_ff", "fsdp")),
        },
    }
    if not cfg.tie_embeddings:
        t["unembed"] = P((d, cfg.vocab_size), ("fsdp", "tp_vocab"))
    return t


def _capacity(cfg: ArchConfig, num_tokens: int) -> int:
    c = int(math.ceil(cfg.capacity_factor * num_tokens *
                      cfg.experts_per_token / cfg.num_experts))
    return max(8, min(c, num_tokens))  # pad to a sane floor, cap at T


def _route(cfg: ArchConfig, xf, router):
    """(T, d) tokens -> (top_p, top_e, aux) router outputs, in fp32."""
    E, k = cfg.num_experts, cfg.experts_per_token
    T = xf.shape[0]
    logits = xf.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)                        # (T, E)
    top_p, top_e = torch.topk(probs, k, dim=-1)                  # (T, k)
    top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)
    # Switch-style load-balance aux loss
    me = probs.mean(dim=0)
    flat_e = top_e.reshape(-1)
    ce = torch.zeros(E, dtype=torch.float32, device=xf.device).scatter_add_(
        0, flat_e, torch.ones(flat_e.shape, device=xf.device)) / (T * k)
    aux = E * torch.sum(me * ce)
    return top_p, top_e, aux


def _dispatch(xf, top_e, top_p, E: int, C: int):
    """Sort-based capacity dispatch: (T,d) -> (E,C,d) + combine metadata
    ``(dest, ok, st, sw, inv)``.  Dropped entries (past C in their
    expert, in the stable sort's order) write the spare row E*C."""
    T, d = xf.shape
    k = top_e.shape[-1]
    dev = xf.device
    flat_e = top_e.reshape(-1)                                   # (T*k,)
    flat_w = top_p.reshape(-1)
    flat_t = torch.arange(T, device=dev)[:, None].expand(T, k).reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se, st, sw = flat_e[order], flat_t[order], flat_w[order]
    counts = torch.zeros(E, dtype=torch.long, device=dev).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.arange(T * k, device=dev) - starts[se]
    ok = pos_in_e < C
    dest = torch.where(ok, se * C + pos_in_e, E * C)             # drop slot
    xbuf = xf.new_zeros((E * C + 1, d)).index_put((dest,), xf[st])
    inv = torch.empty_like(order).index_copy_(
        0, order, torch.arange(T * k, device=dev))
    return xbuf[:-1].reshape(E, C, d), (dest, ok, st, sw, inv)


def _combine(y_flat, meta, T: int, dtype):
    """(E*C, d) expert outputs -> (T, d) weighted combine: each entry's
    weighted row, back in (token, choice) order, summed over the k
    choices in that order."""
    dest, ok, _, sw, inv = meta
    n = y_flat.shape[0]
    gathered = y_flat[torch.clamp_max(dest, n - 1)]
    contrib = torch.where(ok[:, None], gathered, 0) * sw[:, None].to(dtype)
    return contrib[inv].reshape(T, -1, y_flat.shape[1]).sum(dim=1).to(dtype)


def _expert_ffn(xbuf, wg, wu, wd):
    """(E, C, d) through per-expert SwiGLU."""
    g = torch.bmm(xbuf, wg)
    u = torch.bmm(xbuf, wu)
    h = torch.nn.functional.silu(g) * u
    return torch.bmm(h, wd)


def moe_ffn_dense(cfg: ArchConfig, lp, x) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d), aux_loss scalar): global dispatch
    over all B*S tokens."""
    b, s, d = x.shape
    E = cfg.num_experts
    T = b * s
    C = _capacity(cfg, T)
    xf = x.reshape(T, d)
    top_p, top_e, aux = _route(cfg, xf, lp["router"])
    xbuf, meta = _dispatch(xf, top_e, top_p, E, C)
    y = _expert_ffn(xbuf, lp["we_gate"], lp["we_up"], lp["we_down"])
    out = _combine(y.reshape(E * C, d), meta, T, x.dtype)
    return out.reshape(b, s, d), aux


def moe_ffn(cfg: ArchConfig, lp, x) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out, aux).  The JAX package picks 'dense', 'a2a'
    or 'local' from its sharding rules; with no mesh all three are the
    dense path, which is the one the port has."""
    return moe_ffn_dense(cfg, lp, x)


def _moe_block(cfg: ArchConfig, lp, x):
    xn = cm.rms_norm(x, lp["ln2"], cfg.norm_eps)
    return moe_ffn(cfg, lp, xn)


def _ffn(cfg: ArchConfig, lp, x):
    """The MoE block as the transformer loops' ``ffn`` (aux dropped)."""
    return _moe_block(cfg, lp, x)[0]


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


def _layer_fwd(cfg: ArchConfig, lp, x, window, backend):
    x = x + tfm.attn(cfg, lp, x, window=window, backend=backend)[0]
    m, aux = _moe_block(cfg, lp, x)
    return x + m, aux


def forward(cfg: ArchConfig, params, tokens, *, window: int = 0,
            remat: bool = True, backend=None):
    """tokens (B, S) -> (logits (B, S, V), aux summed over layers).  With
    ``remat`` and grad on, each layer runs again in the backward (as
    ``jax.checkpoint`` there)."""
    x = tfm._embed(cfg, params, tokens)
    layers = {k: w.unbind(0) for k, w in params["layers"].items()}
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for l in range(cfg.num_layers):
        lp = {k: w[l] for k, w in layers.items()}
        if remat and torch.is_grad_enabled():
            x, a = checkpoint(_layer_fwd, cfg, lp, x, window, backend,
                              use_reentrant=False)
        else:
            x, a = _layer_fwd(cfg, lp, x, window, backend)
        aux = aux + a
    return tfm._logits(cfg, params, x), aux


def loss_fn(cfg: ArchConfig, params, batch, *, window: int = 0,
            backend=None):
    """Next-token cross entropy plus ``router_aux_coef * aux / L``:
    (loss, {"loss", "xent", "aux"})."""
    logits, aux = forward(cfg, params, batch["tokens"], window=window,
                          backend=backend)
    xent = cm.softmax_xent(logits[:, :-1], batch["labels"][:, 1:])
    loss = xent + cfg.router_aux_coef * aux / cfg.num_layers
    return loss, {"loss": loss, "xent": xent, "aux": aux}


# ---------------------------------------------------------------------------
# Serving: the dense transformer's caches and layer loops, MoE block
# ---------------------------------------------------------------------------

init_cache = tfm.init_cache
cache_to_kv_dtype = tfm.cache_to_kv_dtype
cache_splice_paged = tfm.cache_splice_paged
paged_info = tfm.paged_info


def decode_step(cfg: ArchConfig, params, token, cache, pos, *,
                window: int = 0):
    """B lanes at one position (see ``transformer.decode_step``)."""
    return tfm.decode_step(cfg, params, token, cache, pos, window=window,
                           ffn=_ffn)


def decode_step_batch(cfg: ArchConfig, params, tokens, cache, pos, *,
                      window: int = 0, attn_backend=None):
    """Lane-major decode in all four cache forms (see
    ``transformer.decode_step_batch``).  The MoE block routes all B lane
    tokens, idle lanes included, through one dispatch."""
    return tfm.decode_step_batch(cfg, params, tokens, cache, pos,
                                 window=window, attn_backend=attn_backend,
                                 ffn=_ffn)


def prefill(cfg: ArchConfig, params, tokens, cache_len: int, *,
            window: int = 0, cache_dtype=torch.bfloat16, backend=None):
    """The full prompt through the layers; logits and a ring cache (see
    ``transformer.prefill``)."""
    return tfm.prefill(cfg, params, tokens, cache_len, window=window,
                       cache_dtype=cache_dtype, backend=backend, ffn=_ffn)
