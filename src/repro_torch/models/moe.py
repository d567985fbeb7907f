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
JAX package does, and all three are ``compat.shard_map`` bodies.
'dense' computes the JAX package's function of the global batch (its
capacity, its stable order, its drops and its aux) on each rank's own
token shard, and no rank holds a global-batch tensor: the (E*C, d)
buffer is split over the model axis (by experts where E divides it,
else by capacity rows) and either over the token shards, the expert
weights gathered over ``fsdp`` (many tokens: train, prefill), or by the
columns of d, the weights left split over ``fsdp`` and the tokens moved
to them (few tokens: decode).  'a2a' (expert parallelism over an
all-to-all on the model axis) and 'local' (replicated experts) take a
capacity per token shard, a different function.  With no mesh all
three are the dense path.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import common as cm
from repro_torch.models import transformer as tfm
from repro_torch.models.common import P
from repro_torch.sharding_hints import checkpoint, get_rule, hint, is_dtensor

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


def _probs(cfg: ArchConfig, xf, router):
    """(T, d) tokens -> (probs, top_p, top_e): the router's softmax and
    its renormalized top k, in fp32."""
    probs = torch.softmax(xf.float() @ router.float(), dim=-1)   # (T, E)
    top_p, top_e = torch.topk(probs, cfg.experts_per_token, dim=-1)
    top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)
    return probs, top_p, top_e


def _route(cfg: ArchConfig, xf, router):
    """(T, d) tokens -> (top_p, top_e, aux) router outputs, in fp32."""
    E, k = cfg.num_experts, cfg.experts_per_token
    T = xf.shape[0]
    probs, top_p, top_e = _probs(cfg, xf, router)
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
    over all B*S tokens.  On DTensors, :func:`_dense_sharded`."""
    info = _mesh_info(x)
    if info is not None:
        return _dense_sharded(cfg, lp, x, info)
    if is_dtensor(x):
        raise ValueError("moe_ffn_dense on DTensors needs installed rules "
                         "(sharding_hints.axis_rules)")
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


def _all_reduce(x, mesh, axes):
    """Sum of ``x`` over the ranks of mesh ``axes``; no gradient."""
    from torch.distributed import _functional_collectives as fc
    from repro_torch.sharding_hints import mesh_sizes
    sizes = mesh_sizes(mesh)
    for a in axes:
        if sizes[a] > 1:
            x = fc.wait_tensor(fc.all_reduce(x, "sum", mesh.get_group(a)))
    return x


class _Psum(torch.autograd.Function):
    """Sum over the ranks of mesh ``axes`` (``lax.psum``), the result on
    every rank.  A rank's input takes the result's gradient on that rank
    where every rank does the same with the result (psum's transpose
    under ``shard_map``), and the sum of the ranks' result gradients
    where each does its own share of the work with it (``spread``)."""

    @staticmethod
    def forward(ctx, x, mesh, axes, spread):
        ctx.mesh, ctx.axes, ctx.spread = mesh, axes, spread
        return _all_reduce(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        if ctx.spread:
            g = _all_reduce(g, ctx.mesh, ctx.axes)
        return g, None, None, None


def _pmean(x, mesh, axes):
    """Mean over the ranks of mesh ``axes`` (``lax.pmean``); each rank's
    input gets 1/n of the gradient."""
    from repro_torch.sharding_hints import mesh_sizes
    sizes = mesh_sizes(mesh)
    for a in axes:
        n = sizes[a]
        total = _all_reduce(x.detach(), mesh, (a,))
        x = x / n + (total - x.detach()) / n
    return x


def _weight_grad(wspec, token_axes, mesh):
    """Gradient placements of a weight that enters a body with ``wspec``:
    split where the weight is split, a partial sum over the other axes
    that split the work, ``token_axes`` (each rank's grad covers its own
    tokens, or in the dense body its own rows)."""
    from torch.distributed.tensor import Partial
    from repro_torch.sharding_hints import to_placements
    pl = to_placements(wspec, mesh)
    sharded = {a for e in wspec if e for a in ((e,) if isinstance(e, str)
                                              else e)}
    return tuple(Partial() if n not in sharded and n in token_axes else p
                 for n, p in zip(mesh.mesh_dim_names, pl))


def _gather_axes(x, mesh, axes, dim: int = 0):
    """:func:`_all_gather` of ``dim`` over mesh ``axes`` (the first
    outermost: chunk i of the result is the row-major i-th rank's)."""
    from repro_torch.sharding_hints import mesh_sizes
    sizes = mesh_sizes(mesh)
    for a in reversed(axes):
        if sizes[a] > 1:
            x = _all_gather(x, dim, mesh, a)
    return x


def _scatter_axes(x, mesh, axes, dim: int = 0):
    """Sum of ``x`` over the ranks of mesh ``axes``, each keeping its
    row-major chunk of ``dim`` (the transpose of :func:`_gather_axes`,
    which is its gradient)."""
    from torch.distributed import _functional_collectives as fc
    from repro_torch.sharding_hints import mesh_sizes
    scatter = getattr(fc, "reduce_scatter_single_autograd",  # the newer name
                      fc.reduce_scatter_tensor_autograd)
    sizes = mesh_sizes(mesh)
    for a in axes:
        if sizes[a] > 1:
            x = scatter(x.contiguous(), "sum", dim, mesh.get_group(a))
    return x


def _shared_grad(t, n: int):
    """``t``, its gradient divided by ``n`` on the way back: the share of
    each of n ranks that compute the same ``t``, whose gradients are
    summed over them."""
    if n > 1 and t.requires_grad:
        t.register_hook(lambda g: g / n)
    return t


def _token_slices(n: int):
    """Eight slices of range(n) (fewer when n is smaller): the combine's
    temporaries are a slice's rows, not all n."""
    step = max(1, -(-n // 8))
    return [slice(i, min(i + step, n)) for i in range(0, n, step)]


class _Combine(torch.autograd.Function):
    """Each token's k expert outputs, weighted and summed: ``y`` (a rank's
    rows and a zero row) is all-gathered over the mesh ``axes`` into its
    model block's rows, and out[t] is the sum over the k choices c of
    ``w[t, c] * rows[take[t, c]]``, added in order in fp32 and returned
    in y's dtype, a slice of tokens at a time.  The backward gathers the
    rows again rather than keep them, and adds every choice's share into
    one gradient of them (where autograd would build a whole one a
    choice), which a reduce-scatter takes home."""

    @staticmethod
    def forward(ctx, y, take, w, mesh, axes):
        ctx.save_for_backward(y, take, w)
        ctx.mesh, ctx.axes = mesh, axes
        rows = _gather_axes(y, mesh, axes)
        out = y.new_empty((take.shape[0], y.shape[1]))
        for sl in _token_slices(take.shape[0]):
            acc = torch.zeros(out[sl].shape, dtype=torch.float32,
                              device=y.device)
            for c in range(take.shape[1]):
                acc.addcmul_(rows.index_select(0, take[sl, c]),
                             w[sl, c, None])
            out[sl] = acc
        return out

    @staticmethod
    def backward(ctx, g):
        y, take, w = ctx.saved_tensors
        rows = _gather_axes(y, ctx.mesh, ctx.axes)
        gw = torch.empty(w.shape, dtype=torch.float32, device=w.device)
        parts = _token_slices(take.shape[0])
        for sl in parts:
            for c in range(take.shape[1]):
                gw[sl, c] = (g[sl] * rows.index_select(0, take[sl, c])).sum(
                    -1, dtype=torch.float32)
        shape = rows.shape
        del rows
        grows = torch.zeros(shape, dtype=y.dtype, device=y.device)
        for sl in parts:
            for c in range(take.shape[1]):
                grows.index_add_(0, take[sl, c], g[sl] * w[sl, c, None])
        return (_scatter_axes(grows, ctx.mesh, ctx.axes), None,
                gw.to(w.dtype), None, None)


class DenseLayout(NamedTuple):
    """How :func:`_dense_sharded` places the (E*C, d) buffer (see
    :func:`dense_layout`)."""
    route: str              # what the model axis splits: 'experts', 'rows'
    contract: bool          # the expert products contract d over fsdp
    fsdp: Optional[str]     # the mesh axis of the weights' fsdp split
    n_tok: int              # token shards
    m: int                  # model blocks
    e_r: int                # experts a rank's rows hold
    cc: int                 # capacity rows a rank holds per expert


def dense_layout(cfg: ArchConfig, num_tokens: int, sizes, token_axes,
                 model_axis) -> DenseLayout:
    """How :func:`_dense_sharded` splits the (E*C, d) buffer on a mesh of
    axis ``sizes``.  Route 'experts' (E divides the model axis and
    ``experts_act`` maps there): block j of the model axis holds experts
    [j*e_r, (j+1)*e_r).  Route 'rows': every block holds all E experts.

    The expert products take the form that moves less, as the weights
    and the rows a rank's weight shard meets compare:

    - ``contract`` (decode: C * (d + d_ff) < 3 * d * d_ff, the rows and
      their hidden units fewer than an expert's three matrices): the
      weights stay where the parameter rules put them and the tokens go
      to them.  A rank holds all C rows of its block's experts, the
      columns of its ``fsdp`` slice of d, and the products contract d
      over that axis; in route 'rows' the model axis splits d_ff (which
      it must divide) instead of the rows.
    - else (train, prefill) the weights are gathered over ``fsdp`` (in
      route 'rows' over the model axis too), and token shard i of block
      j holds capacity rows [i*cc, (i+1)*cc) of its experts, in route
      'rows' rows [q*cc, (q+1)*cc), q = j * token shards + i.  cc is
      rounded up, so the last rows of a split that does not divide are
      padding that no entry writes."""
    from repro_torch.sharding_hints import logical_to_spec
    E, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    C = _capacity(cfg, num_tokens)
    n = math.prod(sizes[a] for a in token_axes)
    m = sizes[model_axis] if model_axis else 1
    by_experts = m == 1 or logical_to_spec(("experts_act",),
                                           shape=(E,)) == (model_axis,)
    fs = logical_to_spec(("experts", "fsdp", "tp_ff"), shape=(E, d, f))[1]
    fs = fs if isinstance(fs, str) and fs != model_axis else None
    contract = fs is not None and (by_experts or f % m == 0) and \
        C * (d + f) < 3 * d * f
    if contract:
        return DenseLayout("experts" if by_experts else "rows", True, fs, n,
                           m, E // m if by_experts else E, C)
    if by_experts:
        return DenseLayout("experts", False, fs, n, m, E // m, -(-C // n))
    return DenseLayout("rows", False, fs, n, m, E, -(-C // (n * m)))


def _dense_sharded(cfg: ArchConfig, lp, x, info):
    """The dense dispatch on DTensors: JAX's ``moe_ffn_dense`` of the
    global batch, computed on each rank's own tokens.

    x is split over the batch axes (the token shards, in global token
    order) and replicated over the model axis.  Each rank routes its
    tokens; an entry's place in its expert is the count of same-expert
    entries on earlier token shards (an all-gather of each shard's (E,)
    counts) plus its local stable rank, so the capacity C of the global
    batch drops the entries JAX's global argsort drops.  A rank of model
    block j writes its tokens' kept entries of block j into a buffer of
    the rows (``dense_layout``).  With the weights gathered, a
    reduce-scatter over the token axes leaves each row on one owner,
    which runs the experts' SwiGLU on it, the combine all-gathers the
    outputs back over the token axes, and each token owner weights its
    entries' rows and sums its k choices in order.  With ``contract``
    the tokens of the fsdp axis's ranks are all-gathered there (where
    that axis does not split them, its ranks route the same tokens, and
    each takes 1/n of their gradients); each rank fills and combines the
    columns of its fsdp slice of d, the gate and up products summed over
    the axis, and an all-to-all takes each token's columns home.  The
    partial sums of the model blocks are added over the model axis.
    aux is JAX's: the mean of the router's probabilities over all T
    tokens times the global counts / (T*k).  Raises when a rule splits
    ``seq`` (the shards would not be in token order)."""
    from repro_torch.launch.compat import shard_map
    from repro_torch.sharding_hints import logical_to_spec
    mesh, sizes, _, maxis = info
    b, s, d = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    T = b * s
    C = _capacity(cfg, T)
    bspec, sspec, _ = logical_to_spec(("batch", "seq", "embed"),
                                      shape=(b, s, d))
    if sspec is not None:
        raise ValueError(
            f"moe_ffn_dense: the rules split 'seq' over {sspec!r}; the "
            f"dense dispatch needs token shards in global token order "
            f"(split 'batch' only) to drop the entries the global "
            f"capacity drops")
    tok_axes = () if bspec is None else \
        ((bspec,) if isinstance(bspec, str) else tuple(bspec))
    lay = dense_layout(cfg, T, sizes, tok_axes, maxis)
    e_r, cc = lay.e_r, lay.cc
    i0 = 0
    for a in tok_axes:
        i0 = i0 * sizes[a] + mesh.get_local_rank(a)
    j0 = mesh.get_local_rank(maxis) if maxis else 0
    rows = e_r * cc                                  # a rank's rows
    model = (maxis,) if maxis else ()
    fs = lay.fsdp if lay.contract else None
    # contract: the ranks of fs that route the same tokens, and the token
    # axes the buffer is summed over whole
    dup = sizes[fs] if fs and fs not in tok_axes else 1
    whole = tuple(a for a in tok_axes if a != fs)
    dax = fs or ("data" if "data" in tok_axes else None)

    def body(xl, router, wg, wu, wd):
        bl, sl, _ = xl.shape
        n = bl * sl * k
        xf = xl.reshape(bl * sl, d)
        if dax:
            router = _all_gather(router, 0, mesh, dax)
        if dax and not fs:
            wg = _all_gather(wg, 1, mesh, dax)
            wu = _all_gather(wu, 1, mesh, dax)
            wd = _all_gather(wd, 2, mesh, dax)
        probs, top_p, top_e = _probs(cfg, xf, router)
        flat_e = top_e.reshape(-1)                   # (token, choice) order
        counts = torch.zeros(E, dtype=torch.long, device=xf.device)
        counts.scatter_add_(0, flat_e, torch.ones_like(flat_e))
        every = _gather_axes(counts[None], mesh, tok_axes)    # (n_tok, E)
        # aux over the global batch; its gradient is taken once over the
        # model axis, whose ranks route the same tokens
        me = _Psum.apply(probs.sum(0), mesh, tok_axes, False) / T
        ce = every.sum(0).float() / (T * k)
        aux = E * torch.sum(me * ce)
        if j0:
            aux = aux.detach()
        # each entry's place in its expert, in JAX's global stable order
        order = torch.argsort(flat_e, stable=True)
        starts = torch.cumsum(counts, 0) - counts
        rank = torch.arange(n, device=xf.device) - starts[flat_e[order]]
        local = torch.empty_like(order).index_copy_(0, order, rank)
        pos = every[:i0].sum(0)[flat_e] + local
        if lay.route == "experts":
            blk, el = flat_e // e_r, flat_e % e_r
        elif fs:                             # every block holds every row
            blk, el = j0, flat_e
        else:
            blk, el = pos // cc // lay.n_tok, flat_e
        mine = (pos < C) & (blk == j0)
        w = top_p.to(xf.dtype)
        if fs:
            # the block's rows, C an expert, and a spare row that an
            # entry of another block, or a dropped one, writes (and
            # whose zero output it reads).  The fs peers' tokens come
            # together (where fs splits them), each rank fills and
            # combines its columns of the rows, and an all-to-all takes
            # each token's columns to its owner
            at = torch.where(mine, el * C + pos, rows).reshape(-1, k)
            peers = (fs,) if fs in tok_axes else ()
            xg = _gather_axes(xf, mesh, peers)
            at, w = _gather_axes(at, mesh, peers), _gather_axes(w, mesh,
                                                                peers)
            dl = d // sizes[fs]
            r = mesh.get_local_rank(fs)
            xs = xf.new_zeros((rows + 1, dl))
            xs.index_put_((at,), xg[:, None, r * dl:(r + 1) * dl])
            del xg
            xs = _Psum.apply(xs[:rows], mesh, whole, True).reshape(e_r, C,
                                                                   dl)
            g = _Psum.apply(torch.bmm(xs, wg), mesh, (fs,), True)
            u = _Psum.apply(torch.bmm(xs, wu), mesh, (fs,), True)
            del xs
            h = torch.nn.functional.silu(g) * u
            del g, u
            y = torch.bmm(h, wd).reshape(rows, dl)
            del h
        else:
            # the block's rows as n_tok chunks of an owner's rows and a
            # spare row, written and read as above
            tok = pos // cc % lay.n_tok if lay.route == "rows" else pos // cc
            at = torch.where(mine, tok * (rows + 1) + el * cc + pos % cc,
                             rows).reshape(-1, k)
            buf = xf.new_zeros((lay.n_tok * (rows + 1), d))
            buf.index_put_((at,), xf[:, None, :])
            xe = _scatter_axes(buf, mesh, tok_axes)[:rows]
            del buf
            y = _expert_ffn(xe.reshape(e_r, cc, d), wg, wu, wd)
            y = y.reshape(rows, d)
            del xe
        y = torch.cat([y, y.new_zeros(1, y.shape[1])])
        out = _Combine.apply(y, at, w, mesh, () if fs else tok_axes)
        del y
        if fs in tok_axes and sizes[fs] > 1:
            out = _all_to_all(out, mesh, fs).reshape(sizes[fs], -1, dl)
            out = out.transpose(0, 1).reshape(-1, d)
        elif fs:
            out = _gather_axes(out, mesh, (fs,), dim=1)
        out = _Psum.apply(out, mesh, model, False)
        return (_shared_grad(out.reshape(bl, sl, d), dup),
                _shared_grad(aux, dup))

    xspec = (bspec, None, None)
    row_axes = set(tok_axes) | set(model) | ({fs} if fs else set())
    ex = maxis if lay.route == "experts" and lay.m > 1 else None
    fx = maxis if fs and lay.route == "rows" and lay.m > 1 else None
    rspec, wspec, dspec = (dax, None), (ex, dax, fx), (ex, fx, dax)
    grads = tuple(_weight_grad(w, row_axes, mesh)
                  for w in (xspec, rspec, wspec, wspec, dspec))
    fn = shard_map(body, mesh=mesh,
                   in_specs=(xspec, rspec, wspec, wspec, dspec),
                   out_specs=[xspec, ()], in_grad_specs=grads)
    out, aux = fn(x, lp["router"], lp["we_gate"], lp["we_up"],
                  lp["we_down"])
    return hint(out, "batch", "seq", "embed"), aux


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
