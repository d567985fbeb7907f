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

Under a mesh (DTensor parameters and activations, ``launch.sharding``)
``moe_ffn`` picks the implementation from the rule ``moe_impl``, as the
JAX package does: 'dense' runs the dispatch on the whole token buffer,
replicated on every rank, and the experts sharded by the hints; 'a2a'
(expert parallelism over an all-to-all on the model axis) and 'local'
(replicated experts) are ``compat.shard_map`` bodies.  With no mesh all
three are the dense path.
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
from repro_torch.sharding_hints import get_rule, hint, is_dtensor

# The scheduler captures the batched decode step once as a CUDA graph
# (runtime/scheduler.py): decode_step_batch is the dense family's with
# _ffn, and the MoE block reads no device value on the host and shapes
# nothing by data.  _capacity is a host int of the static token count;
# _route's softmax and topk, and _dispatch's stable argsort, scatter_add_
# counts, cumsum and index_put keep fixed shapes; the index_put's
# duplicate indices all land in the drop row E*C, which is thrown away;
# _combine gathers and sums in a fixed order.  The cache is written in
# place by the dense family's writes.
CUDA_GRAPH_SAFE = True


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


def _expert_ffn(xbuf, wg, wu, wd, use_hints: bool = False):
    """(E, C, d) through per-expert SwiGLU.  ``use_hints`` applies the
    logical-axis hints (dense path only: the shard_map paths place
    everything explicitly)."""
    g = torch.bmm(xbuf, wg)
    u = torch.bmm(xbuf, wu)
    h = torch.nn.functional.silu(g) * u
    if use_hints:
        h = hint(h, "experts_act", None, "ff")
    return torch.bmm(h, wd)


def moe_ffn_dense(cfg: ArchConfig, lp, x) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d), aux_loss scalar): global dispatch
    over all B*S tokens.  On DTensors the routing, dispatch and combine
    run on the whole token buffer, replicated on every rank (what GSPMD
    makes of the JAX package's data-dependent scatter), and the expert
    products are sharded by the hints."""
    b, s, d = x.shape
    E = cfg.num_experts
    T = b * s
    C = _capacity(cfg, T)
    xf = x.reshape(T, d)

    def route_dispatch(xf, router):
        top_p, top_e, aux = _route(cfg, xf, router)
        xbuf, meta = _dispatch(xf, top_e, top_p, E, C)
        return (xbuf, aux) + meta

    def combine(y, *meta):
        return _combine(y, meta, T, x.dtype)

    if is_dtensor(xf):
        from repro_torch.launch.compat import shard_map
        mesh, rep = xf.device_mesh, ()
        route_dispatch = shard_map(route_dispatch, mesh=mesh,
                                   in_specs=(rep, rep), out_specs=[rep] * 7)
        combine = shard_map(combine, mesh=mesh, in_specs=(rep,) * 6,
                            out_specs=rep)
    xbuf, aux, *meta = route_dispatch(xf, lp["router"])
    xbuf = hint(xbuf, "experts_act", None, None)
    y = _expert_ffn(xbuf, lp["we_gate"], lp["we_up"], lp["we_down"],
                    use_hints=True)
    out = combine(y.reshape(E * C, d), *meta)
    return hint(out.reshape(b, s, d), "batch", "seq", "embed"), aux


def _mesh_info(x):
    """(mesh, axis sizes, batch axes, model axis) when ``x`` is a DTensor
    under installed rules, else None."""
    from repro_torch.sharding_hints import active_mesh, mesh_sizes
    mesh = active_mesh()
    if mesh is None or not is_dtensor(x):
        return None
    names = mesh.mesh_dim_names
    batch_axes = tuple(a for a in ("pod", "data") if a in names)
    model_axis = "model" if "model" in names else None
    return x.device_mesh, mesh_sizes(mesh), batch_axes, model_axis


def _all_gather(x, dim: int, mesh, axis):
    """Tiled all-gather of ``x`` along ``dim`` over a mesh axis; its
    gradient is the reduce-scatter of the gathered gradient."""
    from torch.distributed import _functional_collectives as fc
    gather = getattr(fc, "all_gather_single_autograd",   # the newer name
                     fc.all_gather_tensor_autograd)
    return gather(x.contiguous(), dim, mesh.get_group(axis))


def _all_to_all(x, mesh, axis):
    """Chunk j of ``x``'s dim 0 to the j-th rank of a mesh axis; chunk j
    of the result came from it (``lax.all_to_all``, split = concat = 0)."""
    from torch.distributed import _functional_collectives as fc
    return fc.all_to_all_single_autograd(x.contiguous(), None, None,
                                         mesh.get_group(axis))


def _pmean(x, mesh, axes):
    """Mean over the ranks of mesh ``axes`` (``lax.pmean``); each rank's
    input gets 1/n of the gradient."""
    from torch.distributed import _functional_collectives as fc
    from repro_torch.sharding_hints import mesh_sizes
    sizes = mesh_sizes(mesh)
    for a in axes:
        n = sizes[a]
        total = fc.all_reduce(x.detach(), "sum", mesh.get_group(a))
        x = x / n + (total - x.detach()) / n
    return x


def _weight_grad(wspec, token_axes, mesh):
    """Gradient placements of a weight that enters a body with ``wspec``:
    split where the weight is split, a partial sum over the other axes
    that split the tokens (each rank's grad covers its own tokens)."""
    from torch.distributed.tensor import Partial
    from repro_torch.sharding_hints import to_placements
    pl = to_placements(wspec, mesh)
    sharded = {a for e in wspec if e for a in ((e,) if isinstance(e, str)
                                              else e)}
    return tuple(Partial() if n not in sharded and n in token_axes else p
                 for n, p in zip(mesh.mesh_dim_names, pl))


def moe_ffn_a2a(cfg: ArchConfig, lp, x) -> Tuple[torch.Tensor,
                                                 torch.Tensor]:
    """Expert-parallel path: tokens dispatched locally per shard (the
    dense path's arithmetic), an all-to-all along the ``model`` axis
    takes each expert's slots to its owner, and a reverse all-to-all
    brings the results home.  Requires E % model axis == 0."""
    info = _mesh_info(x)
    if info is None:
        return moe_ffn_dense(cfg, lp, x)
    from repro_torch.launch.compat import shard_map
    mesh, sizes, batch_axes, maxis = info
    b, s, d = x.shape
    E = cfg.num_experts
    m = sizes[maxis]
    if E % m:
        raise ValueError(f"a2a needs the model axis ({m}) to divide the "
                         f"{E} experts")
    e_loc = E // m
    # shard seq over model when it divides; decode (s == 1) keeps it whole
    seq_axis = maxis if s % m == 0 and s > 1 else None
    dax = "data" if "data" in sizes else None
    token_axes = set(batch_axes) | ({seq_axis} if seq_axis else set())

    def body(xl, router, wg, wu, wd):
        bl, sl, _ = xl.shape
        T_loc = bl * sl
        xf = xl.reshape(T_loc, d)
        if dax:
            router = _all_gather(router, 0, mesh, dax)
            wg = _all_gather(wg, 1, mesh, dax)
            wu = _all_gather(wu, 1, mesh, dax)
            wd = _all_gather(wd, 2, mesh, dax)
        top_p, top_e, aux = _route(cfg, xf, router)
        C = _capacity(cfg, T_loc)
        xbuf, meta = _dispatch(xf, top_e, top_p, E, C)       # (E, C, d)
        recv = _all_to_all(xbuf.reshape(m, e_loc, C, d), mesh, maxis)
        # (m peers, e_loc, C, d) -> (e_loc, m * C, d)
        xe = recv.transpose(0, 1).reshape(e_loc, m * C, d)
        y = _expert_ffn(xe, wg, wu, wd)
        back = y.reshape(e_loc, m, C, d).transpose(0, 1)
        got = _all_to_all(back, mesh, maxis)                 # (m, e_loc, C, d)
        out = _combine(got.reshape(E * C, d), meta, T_loc, x.dtype)
        # over the model axis without seq the tokens (so aux) are equal
        aux = _pmean(aux, mesh, tuple(a for a in (*batch_axes, seq_axis)
                                      if a))
        return out.reshape(bl, sl, d), aux

    xspec = (batch_axes, seq_axis, None)
    rspec = (dax, None)
    wspec = (maxis, dax, None)
    dspec = (maxis, None, dax)
    grads = tuple(_weight_grad(w, token_axes, mesh)
                  for w in (rspec, wspec, wspec, dspec))
    fn = shard_map(body, mesh=mesh,
                   in_specs=(xspec, rspec, wspec, wspec, dspec),
                   out_specs=[xspec, ()],
                   in_grad_specs=(xspec,) + grads)
    out, aux = fn(x, lp["router"], lp["we_gate"], lp["we_up"],
                  lp["we_down"])
    return hint(out, "batch", "seq", "embed"), aux


def moe_ffn_local(cfg: ArchConfig, lp, x) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """Replicated-experts path for banks that do not divide the model
    axis (granite: 40 experts on 16): tokens split over every mesh axis,
    each rank runs all experts on its own tokens; no dispatch
    collectives, the expert weights replicated on the model axis."""
    info = _mesh_info(x)
    if info is None:
        return moe_ffn_dense(cfg, lp, x)
    from repro_torch.launch.compat import shard_map
    mesh, sizes, batch_axes, maxis = info
    b, s, d = x.shape
    E = cfg.num_experts
    msize = sizes[maxis] if maxis else 1
    seq_axis = maxis if maxis and s % msize == 0 and s > 1 else None
    dax = "data" if "data" in sizes else None
    token_axes = set(batch_axes) | ({seq_axis} if seq_axis else set())

    def body(xl, router, wg, wu, wd):
        bl, sl, _ = xl.shape
        T_loc = bl * sl
        xf = xl.reshape(T_loc, d)
        if dax:
            router = _all_gather(router, 0, mesh, dax)
            wg = _all_gather(wg, 1, mesh, dax)
            wu = _all_gather(wu, 1, mesh, dax)
            wd = _all_gather(wd, 2, mesh, dax)
        top_p, top_e, aux = _route(cfg, xf, router)
        C = _capacity(cfg, T_loc)
        xbuf, meta = _dispatch(xf, top_e, top_p, E, C)
        y = _expert_ffn(xbuf, wg, wu, wd)
        out = _combine(y.reshape(E * C, d), meta, T_loc, x.dtype)
        aux = _pmean(aux, mesh, tuple(a for a in (*batch_axes, seq_axis)
                                      if a))
        return out.reshape(bl, sl, d), aux

    xspec = (batch_axes, seq_axis, None)
    rspec = (dax, None)
    wspec = (None, dax, None)
    dspec = (None, None, dax)
    grads = tuple(_weight_grad(w, token_axes, mesh)
                  for w in (rspec, wspec, wspec, dspec))
    fn = shard_map(body, mesh=mesh,
                   in_specs=(xspec, rspec, wspec, wspec, dspec),
                   out_specs=[xspec, ()],
                   in_grad_specs=(xspec,) + grads)
    out, aux = fn(x, lp["router"], lp["we_gate"], lp["we_up"],
                  lp["we_down"])
    return hint(out, "batch", "seq", "embed"), aux


def moe_ffn(cfg: ArchConfig, lp, x) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out, aux).  The implementation comes from the
    active rule ``moe_impl``: 'dense' (default), 'a2a' (expert-parallel
    all-to-all) or 'local' (replicated experts)."""
    impl = get_rule("moe_impl", "dense")
    if impl == "a2a":
        return moe_ffn_a2a(cfg, lp, x)
    if impl == "local":
        return moe_ffn_local(cfg, lp, x)
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
    x = cm.embed_lookup(params["embed"], tokens)
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
cache_spec = tfm.cache_spec
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
