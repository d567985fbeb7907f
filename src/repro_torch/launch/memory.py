"""Per-rank live memory of a step, counted storage by storage as it runs:
the dry run's ``memory_analysis`` (argument, output, temporary and peak
bytes, XLA's four fields in the JAX package).

:class:`LiveBytes` is a ``TorchDispatchMode`` that the dry run enters
beside ``op_costs.OpCosts``, so one pass gives both counts.  It follows
each untyped storage an aten op creates on this rank by a weak
reference: a storage is live from the op that creates it until its last
reference goes (a tensor, a view, autograd's saved tensors, a kernel's
kept workspace).  Views and in-place ops create none.  Each storage is
charged as the CUDA caching allocator charges a block: its bytes rounded
up to :data:`ROUND`.

* Arguments (:meth:`LiveBytes.arguments`) are live from the start.
* DTensor's shape propagation on fake tensors allocates nothing and is
  not charged; the local temporaries of a redistribute are ordinary ops
  here, and so are collectives' outputs (the dry run's fake group returns
  at once, the card allocates them all the same).
* Where the card runs a hand-written kernel and this device runs its
  plain version (meta tensors in the dry run, CPU tensors in the tests),
  the plain ops stay what ``OpCosts`` counts, but what is charged is the
  kernel's footprint: :func:`as_kernel` (forward only) and
  :func:`trainable_as_kernel` (a kernel with a backward) run the plain
  version without charging it, and the kernel's wrapper on meta stand-ins
  of the inputs with ``OpCosts`` paused; a meta tensor takes a wrapper's
  checks and allocations and launches nothing.  The plain outputs then
  take over the charges of the kernel's outputs.  A wrapper that refuses
  its inputs raises here as it does on the card.  The call sites, each
  where a backend left to the device resolves to the plain version, are
  ``models.common.flash_attention_named`` (B8, B9: through
  :func:`flash_attention`), ``decode_attention_named`` and
  ``cache_attend_sharded`` (B6/B7) and ``models.rwkv6.wkv_named`` (B10:
  through :func:`rwkv6_chunked`): the kernels a dry-run pair reaches.
* Where the card's kernel refuses what the step gives it (B10 on fp16
  inputs: the card raises), the plain version is charged as it runs and
  the count names the site and the refusal in ``plain_charged``
  (:meth:`LiveBytes.note_plain`).  No dry-run pair reaches a refusal.

The kernels' buffers, as their wrappers allocate them:

* per launch (temporaries): B9's backward dsum, B8/B9's contiguous
  copies of strided inputs, B6/B7's fp32 copy of q and int32 valid_len,
  B10's contiguous inputs and, above ``KEEP_BYTES``, its records; B1's
  split-K partial sums (``kernels/matmul.py``) and B2's split workspace
  (``kernels/conv2d.py``), whose wrappers no dry-run pair reaches.
* kept across calls (live from the first call on, so charged by the
  count that first calls them): B6/B7's workspace per (stream,
  geometry), B10's ``KEEP_BYTES`` records per stream, and B11's split
  workspace (``kernels/int8_matmul.py``, no dry-run pair reaches it).
  Each count starts with none on meta: :func:`kernels.ops.drop_meta`.

Not modelled: NCCL's own buffers, cuBLAS's workspaces, the allocator's
fragmentation and its cached free blocks (reserved, not allocated), and
blocks the allocator leaves unsplit (a block's tail under 1 MiB in the
large pool is charged to the tensor on the card).
"""
from __future__ import annotations

import contextlib
import functools
import weakref
from typing import Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)
from torch.utils._pytree import tree_flatten, tree_leaves

ROUND = 512        # the caching allocator's block granularity (bytes)
# ops whose output stands for their input: a collective's output wrapped
# for autograd (an AsyncCollectiveTensor on the card), and its wait
_ALIASES = ("_c10d_functional._wrap_tensor_autograd.default",
            "_c10d_functional.wait_tensor.default")
_LEAF = 2 ** 64 - 1   # an AccumulateGrad node's sequence number


def block_bytes(nbytes: int) -> int:
    """``nbytes`` as the caching allocator charges them: a multiple of
    :data:`ROUND` (0 stays 0: an empty tensor takes no block)."""
    return -(-nbytes // ROUND) * ROUND


def _local(t):
    return t.to_local() if hasattr(t, "to_local") else t


class LiveBytes(TorchDispatchMode):
    """Charges every storage created under it on this rank; after the
    step, :meth:`analysis` gives the peak of all live bytes and the peak
    of those that are neither arguments nor outputs."""

    def __init__(self):
        super().__init__()
        self._live: Dict[int, Tuple[int, int]] = {}   # storage -> (id, bytes)
        self._fin: Dict[int, weakref.finalize] = {}
        self._events = []                  # (id, +bytes or -bytes)
        self._args = set()
        self._next = 0
        self._quiet = 0
        self._quiet_nodes = set()          # sequence numbers
        self.plain_charged = []            # [site, why the kernel refused]

    def __enter__(self):
        from repro_torch.kernels import ops as kops
        kops.drop_meta()
        return super().__enter__()

    def __exit__(self, *exc):
        from repro_torch.kernels import ops as kops
        out = super().__exit__(*exc)
        for f in self._fin.values():
            f.detach()
        self._fin.clear()
        kops.drop_meta()
        return out

    # -- charging ----------------------------------------------------------

    def _charge(self, t) -> Optional[int]:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return None
        sid = self._next
        self._next += 1
        b = block_bytes(st.nbytes())
        self._live[key] = (sid, b)
        self._events.append((sid, b))
        self._fin[key] = weakref.finalize(st, self._free, key, sid)
        return sid

    def _free(self, key, sid):
        entry = self._live.get(key)
        if entry is not None and entry[0] == sid:
            del self._live[key]
            self._fin.pop(key, None)
            self._events.append((sid, -entry[1]))

    def arguments(self, tree) -> None:
        """The step's arguments: live from the start, never temporaries."""
        for t in tree_leaves(tree):
            if isinstance(t, torch.Tensor):
                sid = self._charge(_local(t))
                if sid is not None:
                    self._args.add(sid)

    def adopt(self, real, kernel) -> None:
        """``real`` (a plain version's output, not charged) takes over the
        charge of ``kernel`` (the kernel's output on meta): one live
        block, freed when ``real``'s storage goes."""
        kst = kernel.untyped_storage()
        if kst._cdata == real.untyped_storage()._cdata:
            return
        entry = self._live.pop(kst._cdata, None)
        if entry is None:
            return
        self._fin.pop(kst._cdata).detach()
        st = real.untyped_storage()
        if st._cdata in self._live:     # already charged: one block stays
            self._events.append((entry[0], -entry[1]))
            return
        self._live[st._cdata] = entry
        self._fin[st._cdata] = weakref.finalize(st, self._free, st._cdata,
                                                entry[0])

    def note_plain(self, site: str, why: str) -> None:
        """``site`` ran its plain version, charged as it ran, because the
        card's kernel refuses its inputs (``why``)."""
        if [site, why] not in self.plain_charged:
            self.plain_charged.append([site, why])

    @contextlib.contextmanager
    def quiet(self):
        """Storages created inside are not charged (a plain version that
        stands in for a kernel)."""
        self._quiet += 1
        try:
            yield
        finally:
            self._quiet -= 1

    def quiet_graph(self, out, stop) -> None:
        """The autograd nodes from ``out`` back to ``stop`` run the plain
        version's backward: nothing they create is charged."""
        todo, end = [out.grad_fn], stop._sequence_nr()
        while todo:
            node = todo.pop()
            if node is None:
                continue
            seq = node._sequence_nr()
            # a leaf's AccumulateGrad: every one has the same number
            if seq in (end, _LEAF) or seq in self._quiet_nodes:
                continue
            self._quiet_nodes.add(seq)
            todo.extend(n for n, _ in node.next_functions)

    def _is_quiet(self) -> bool:
        if self._quiet:
            return True
        node = torch._C._current_autograd_node()
        return node is not None and node._sequence_nr() in self._quiet_nodes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed._functional_collectives import \
            AsyncCollectiveTensor
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, (DTensor, AsyncCollectiveTensor))
               for t in types):
            return NotImplemented      # charge the ops on what they wrap
        out = func(*args, **kwargs)
        flat_in = [a for a in tree_flatten((args, kwargs))[0]
                   if isinstance(a, torch.Tensor)]
        if any(isinstance(a, FakeTensor) for a in flat_in) or \
                self._is_quiet():
            return out
        outs = [t for t in tree_flatten(out)[0] if type(t) is torch.Tensor]
        if str(func) in _ALIASES:
            # on the card the wrapper holds the collective's output; on
            # meta a new tensor stands for it
            for t in outs:
                self.adopt(t, flat_in[0])
            return out
        inputs = {a.untyped_storage()._cdata for a in flat_in}
        for t in outs:
            if t.untyped_storage()._cdata not in inputs:
                self._charge(t)
        return out

    # -- the result --------------------------------------------------------

    def analysis(self, outputs) -> Dict[str, int]:
        """``peak_bytes``: the most bytes live at once, arguments
        included; ``temp_bytes``: the most live at once of the storages
        that are neither arguments nor (still live) ``outputs``;
        ``plain_charged``: the sites charged as their plain versions
        (:meth:`note_plain`)."""
        outs = set()
        for t in tree_leaves(outputs):
            if isinstance(t, torch.Tensor):
                entry = self._live.get(_local(t).untyped_storage()._cdata)
                if entry is not None:
                    outs.add(entry[0])
        skip = self._args | outs
        live = peak = tlive = temp = 0
        for sid, d in self._events:
            live += d
            peak = max(peak, live)
            if sid not in skip:
                tlive += d
                temp = max(temp, tlive)
        return {"peak_bytes": peak, "temp_bytes": temp,
                "plain_charged": [list(x) for x in self.plain_charged]}


def charging() -> Optional[LiveBytes]:
    """The active :class:`LiveBytes` count, unless it is quiet."""
    for m in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(m, LiveBytes):
            return None if m._quiet else m
    return None


def _stand_ins(count: LiveBytes, xs):
    """Meta tensors with each input's shape, strides and offset (a meta
    input, or anything not a tensor, stands for itself), made without a
    charge."""
    def meta(x):
        if not isinstance(x, torch.Tensor) or x.is_meta:
            return x
        base = torch.empty(x.untyped_storage().nbytes() // x.element_size(),
                           dtype=x.dtype, device="meta")
        return base.as_strided(x.size(), x.stride(), x.storage_offset())
    with count.quiet():
        return [meta(x) for x in xs]


def as_kernel(plain, kernel, *xs, **kw):
    """``plain(*xs, **kw)``'s values, charged as ``kernel`` allocates:
    the plain ops are counted by ``OpCosts`` and charge nothing,
    ``kernel`` runs on meta stand-ins with ``OpCosts`` paused, and the
    plain outputs take over its outputs' charges (the two return the same
    structure).  A wrapper that refuses the inputs raises, as on the
    card.  Without an active count, ``plain(*xs, **kw)``."""
    from repro_torch.launch.op_costs import paused
    count = charging()
    if count is None:
        return plain(*xs, **kw)
    names = list(kw)
    ins = _stand_ins(count, list(xs) + [kw[n] for n in names])
    with paused():
        got = kernel(*ins[:len(xs)], **dict(zip(names, ins[len(xs):])))
    with count.quiet():
        out = plain(*xs, **kw)
    for real, k in zip(tree_leaves(out), tree_leaves(got)):
        count.adopt(real, k)
    return out


class _Link:
    """What a kernel's forward and backward stand-ins share."""

    def __init__(self, count, forward, backward):
        self.count, self.forward, self.backward = count, forward, backward
        self.grads = None


class _Enter(torch.autograd.Function):
    """Identity on the kernel's inputs; its backward hands the gradients
    the plain version computed the charges of the kernel's gradients."""

    @staticmethod
    def forward(ctx, link, *xs):
        ctx.link = link
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        link = ctx.link
        for g, k in zip(grads, link.grads or ()):
            if g is not None and k is not None:
                link.count.adopt(g, k)
        link.grads = None
        return (None,) + grads


class _Leave(torch.autograd.Function):
    """Identity on the plain output; its forward charges the kernel's
    forward and saves what the kernel's ``autograd.Function`` saves, its
    backward charges the kernel's backward and passes dO to the plain
    version's backward."""

    @staticmethod
    def forward(ctx, link, out, *xs):
        from repro_torch.launch.op_costs import paused
        with paused():
            got, extra = link.forward(*_stand_ins(link.count, xs))
        o = out.view_as(out)
        link.count.adopt(o, got)
        ctx.link, ctx.n = link, len(xs)
        ctx.save_for_backward(*xs, o, *extra)
        return o

    @staticmethod
    def backward(ctx, do):
        from repro_torch.launch.op_costs import paused
        link = ctx.link
        saved = _stand_ins(link.count, ctx.saved_tensors + (do,))
        with paused():
            link.grads = link.backward(*saved)
        return (None, do) + (None,) * ctx.n


def trainable_as_kernel(plain, forward, backward, *xs):
    """A differentiable ``plain(*xs)`` charged as a kernel with a
    backward: ``forward(*xs) -> (out, extra)`` allocates as the kernel's
    forward does (``extra``: what it saves besides its inputs and
    output), ``backward(*xs, out, *extra, dout)`` returns the gradients
    of ``xs`` as the kernel's backward allocates them.  The plain
    version's forward and backward are counted by ``OpCosts`` and charge
    nothing; the kernel's gradients stay charged until the plain ones
    reach the inputs and take them over.  Without an active count,
    ``plain(*xs)``."""
    count = charging()
    if count is None:
        return plain(*xs)
    link = _Link(count, forward, backward)
    ins = _Enter.apply(link, *xs)
    with count.quiet():
        out = plain(*ins)
    count.quiet_graph(out, stop=ins[0].grad_fn)
    return _Leave.apply(link, out, *xs)


def flash_attention(plain, q, k, v, *, causal: bool, window: int):
    """``plain(q, k, v)`` (the plain attention), charged as the card's
    flash kernels allocate: B9's forward and backward where grad is on
    and an input requires it, else B8."""
    if charging() is None:
        return plain(q, k, v)
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab
    mask = dict(causal=causal, window=window)
    if not (torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                         or v.requires_grad)):
        return as_kernel(plain, functools.partial(fa.flash_attention, **mask),
                         q, k, v)

    def forward(*x):
        o, lse = fa.flash_fwd_lse(*x, **mask)
        return o, (lse,)

    return trainable_as_kernel(
        plain, forward, functools.partial(fab.backward_kernels, **mask),
        q, k, v)


def rwkv6_chunked(plain, r, k, v, w, u):
    """``plain(r, k, v, w, u)`` (the plain chunked WKV), charged as B10
    allocates; where B10 refuses the dtypes (the card raises there too),
    charged as it runs and noted in the count's ``plain_charged``."""
    count = charging()
    if count is None:
        return plain(r, k, v, w, u)
    from repro_torch.kernels import rwkv6_chunk
    why = rwkv6_chunk.dtype_refusal(r, k, v, w)
    if why is not None:
        count.note_plain("models.rwkv6.wkv_named (B10)", why)
        return plain(r, k, v, w, u)
    return as_kernel(plain, rwkv6_chunk.rwkv6_chunked, r, k, v, w, u)
