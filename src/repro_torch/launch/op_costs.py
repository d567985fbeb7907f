"""Per-device FLOPs, bytes and collective wire bytes of a step, counted
op by op as it runs.

The port's counterpart of two JAX modules: ``repro.launch.hlo_costs``
(``analyze``: FLOPs, fusion-boundary bytes and collective wire bytes of
compiled HLO, trip-count aware) and ``repro.launch.hlo_analysis``
(``analyze_collectives``: the ring model below).  Here there is no HLO:
:class:`OpCosts` is a ``TorchDispatchMode`` that records each aten op once
it runs, on the rank's local tensors.

* FLOPs come from ``torch.utils.flop_counter``'s registry (matmuls,
  convolutions, attention), as the JAX side counts only ``dot`` and
  ``convolution``.
* Bytes are every op's operands plus its results: eager torch has no
  fusion, so every op is a boundary.  Views and allocations move nothing.
* A Python loop over layers runs its body once per layer, so no trip
  count is parsed; the counts are the executed ones.  A loop whose trips
  all have the same shapes may run two trips on meta tensors and count
  the second for the rest (:func:`trips`: the chunk loops of the plain
  attention, thousands of trips at 32k tokens).
* Collectives are counted by kind, result bytes and group size, with the
  JAX package's ring factors (:func:`wire_bytes`).

A DTensor op is not counted itself (it would count the *global* op):
the mode steps aside and counts the local ops and collectives the DTensor
dispatch issues on this rank.  The shape propagation DTensor runs on fake
tensors is not counted either.

``hlo_costs.xla_cost_analysis`` (XLA's own, loop-blind cost analysis)
has no twin: there is no compiler to ask.
"""
from __future__ import annotations

from collections import defaultdict
from contextlib import contextmanager
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")

# op name (namespace.op) -> collective kind; the autograd variants issue
# the plain op, which is the one counted
_COLLECTIVE_OPS = {
    "_c10d_functional.all_gather_into_tensor": "all-gather",
    "_c10d_functional.all_gather_into_tensor_coalesced": "all-gather",
    "_c10d_functional.reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional.reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_c10d_functional.all_reduce": "all-reduce",
    "_c10d_functional.all_reduce_coalesced": "all-reduce",
    "_c10d_functional.all_to_all_single": "all-to-all",
    "_dtensor.shard_dim_alltoall": "all-to-all",
}

# bookkeeping: no bytes moved
_FREE = {"aten.empty", "aten.empty_strided", "aten.empty_like",
         "aten.detach", "aten.lift_fresh", "aten.lift_fresh_copy",
         "aten._local_scalar_dense", "aten.new_empty",
         "aten.new_empty_strided",
         "_c10d_functional.wait_tensor",
         "_c10d_functional._wrap_tensor_autograd"}


def wire_bytes(kind: str, nbytes: float, group: int) -> float:
    """Bytes each rank moves over its links for one collective whose
    result is ``nbytes`` on a group of ``group`` ranks (the JAX package's
    ring model, ``hlo_analysis.analyze_collectives``)."""
    frac = (group - 1) / group if group > 1 else 0.0
    if kind == "all-gather":          # each rank receives (g-1)/g of it
        return nbytes * frac
    if kind == "reduce-scatter":      # the result is the shard
        return nbytes * max(group - 1, 0)
    if kind == "all-reduce":          # reduce-scatter + all-gather
        return 2.0 * nbytes * frac
    if kind == "all-to-all":
        return nbytes * frac
    if kind == "collective-permute":
        return float(nbytes)
    raise ValueError(f"unknown collective {kind!r}")


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _group_size(name) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(name).size()


class OpCosts(TorchDispatchMode):
    """Counts what runs under it on this rank: ``flops``, ``bytes``,
    ``collectives`` ({kind: {count, tensor_bytes, wire_bytes}}),
    ``wire_bytes`` and ``ops`` (aten calls counted)."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flop_fns = flop_registry
        self.scale = 1            # trips each recorded op stands for
        self.flops = 0
        self.bytes = 0
        self.ops = 0
        self.collectives: Dict[str, Dict[str, float]] = defaultdict(
            lambda: {"count": 0, "tensor_bytes": 0.0, "wire_bytes": 0.0})

    @property
    def wire_bytes(self) -> float:
        return sum(v["wire_bytes"] for v in self.collectives.values())

    def summary(self) -> Dict[str, object]:
        return {"flops": self.flops, "bytes": self.bytes,
                "wire_bytes": self.wire_bytes, "ops": self.ops,
                "collectives": {k: dict(v)
                                for k, v in self.collectives.items()}}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented      # count the local ops it issues
        out = func(*args, **kwargs)
        flat_in, _ = tree_flatten((args, kwargs))
        if any(isinstance(a, FakeTensor) for a in flat_in):
            return out                 # DTensor's shape propagation
        self._record(func, flat_in, out, args, kwargs)
        return out

    def _record(self, func, flat_in, out, args, kwargs):
        packet = func._overloadpacket
        name = f"{func.namespace}.{packet.__name__}"
        if name in _FREE or func.is_view:
            return
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        kind = _COLLECTIVE_OPS.get(name)
        if kind is not None:
            nbytes = sum(_nbytes(t) for t in outs)
            group = _group_size(kwargs.get("group_name", args[-1]))
            st = self.collectives[kind]
            st["count"] += self.scale
            st["tensor_bytes"] += nbytes * self.scale
            st["wire_bytes"] += wire_bytes(kind, nbytes, group) * self.scale
            return
        self.ops += self.scale
        if packet in self._flop_fns:
            self.flops += self.scale * int(
                self._flop_fns[packet](*args, **kwargs, out_val=out))
        self.bytes += self.scale * (
            sum(_nbytes(t) for t in flat_in if isinstance(t, torch.Tensor))
            + sum(_nbytes(t) for t in outs))


class trips:
    """``range(n)`` for a loop whose trips all have the same shapes; on
    ``meta`` tensors (the dry run) two trips, the first counted once and
    the second, by each active :class:`OpCosts`, for the other ``n - 1``
    (the JAX cost model's trip-count multiplier).  A loop that collects
    its trips' outputs hands each to :meth:`keep` and reads them from
    ``outs``: on meta the first trip's also stands for the ``n - 2``
    skipped ones (empty tensors of its shape and strides), so the second
    trip runs beside ``n - 1`` held outputs, as the last trip of the full
    loop does, and a memory count (``launch.memory``) sees the full
    loop's peak."""

    def __init__(self, n: int, meta: bool):
        self.n, self.meta, self.outs = n, meta, []

    def __iter__(self):
        return _two_trips(self.n) if self.meta else iter(range(self.n))

    def keep(self, out) -> None:
        self.outs.append(out)
        if self.meta and len(self.outs) == 1:
            self.outs += [torch.empty_like(out) for _ in range(self.n - 2)]


@contextmanager
def paused():
    """Every active :class:`OpCosts` counts nothing inside (a kernel's
    allocations replayed on meta for the memory count)."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack
    modes = [m for m in _get_current_dispatch_mode_stack()
             if isinstance(m, OpCosts)]
    scales = [m.scale for m in modes]
    for m in modes:
        m.scale = 0
    try:
        yield
    finally:
        for m, s in zip(modes, scales):
            m.scale = s


def _two_trips(n: int):
    yield 0
    if n == 1:
        return
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack
    modes = [m for m in _get_current_dispatch_mode_stack()
             if isinstance(m, OpCosts)]
    for m in modes:
        m.scale *= n - 1
    try:
        yield 1
    finally:
        for m in modes:
            m.scale //= n - 1
