"""Logical-axis sharding hints.

The port of ``repro.sharding_hints``.  Model code annotates activations
with *logical* axis names through ``hint``; ``repro_torch.launch.sharding``
installs a rule set (logical name -> mesh axes) and a ``DeviceMesh`` for
the duration of a sharded step.  A spec is a tuple with one entry per
tensor dim (None, a mesh axis name, or a tuple of them), the twin of a
JAX ``PartitionSpec``; :func:`to_placements` turns it into DTensor
placements, one per mesh dim.

``hint`` is ``DTensor.redistribute`` to the rule's placements where JAX
has ``with_sharding_constraint``.  On a plain tensor, or with no rules
installed, it is the identity, so the models stay mesh-agnostic.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional, Sequence, Tuple, Union

MeshAxes = Union[None, str, Tuple[str, ...]]
Spec = Tuple[MeshAxes, ...]

_state = threading.local()


def _rules() -> Optional[Dict[str, MeshAxes]]:
    return getattr(_state, "rules", None)


def _mesh():
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def axis_rules(rules: Dict[str, MeshAxes], mesh=None):
    """Install ``rules`` and ``mesh`` (a ``DeviceMesh`` or a
    ``compat.abstract_mesh``) for this thread until the block exits.
    Under a ``DeviceMesh`` a plain tensor meeting a DTensor in an op
    counts as replicated (positions, masks, constants), as an unsharded
    array does under JAX's mesh."""
    old_r, old_m = _rules(), _mesh()
    _state.rules, _state.mesh = dict(rules), mesh
    try:
        with _implicit_replication(mesh):
            yield
    finally:
        _state.rules, _state.mesh = old_r, old_m


def checkpoint(fn, *args, **kwargs):
    """``torch.utils.checkpoint.checkpoint`` whose recompute runs under
    the rules and mesh installed at the forward: autograd runs a CUDA
    graph's backward, and so the recompute, on a thread of its own, which
    does not see this thread's rules."""
    from torch.utils.checkpoint import checkpoint as torch_checkpoint
    rules, mesh = _rules(), _mesh()

    def contexts():
        return contextlib.nullcontext(), (
            contextlib.nullcontext() if rules is None
            else axis_rules(rules, mesh))
    return torch_checkpoint(fn, *args, context_fn=contexts, **kwargs)


@contextlib.contextmanager
def _implicit_replication(mesh):
    """DTensor's implicit replication on, and on exit back to what it
    was (``implicit_replication()`` turns it off, which would end an
    outer block's too)."""
    from repro_torch.launch.compat import AbstractMesh
    if mesh is None or isinstance(mesh, AbstractMesh):
        yield
        return
    try:
        from torch.distributed.tensor import DTensor
    except ImportError:
        from torch.distributed._tensor import DTensor
    dispatcher = DTensor._op_dispatcher
    old = dispatcher._allow_implicit_replication
    dispatcher._allow_implicit_replication = True
    try:
        yield
    finally:
        dispatcher._allow_implicit_replication = old


def mesh_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or an abstract mesh."""
    names = mesh.mesh_dim_names
    return {n: int(s) for n, s in zip(names, mesh.shape)}


def logical_to_spec(axes: Sequence[Optional[str]],
                    rules: Optional[Dict[str, MeshAxes]] = None,
                    shape: Optional[Sequence[int]] = None) -> Spec:
    """Map logical axis names to a spec under the active rules.

    If ``shape`` is given and a mesh is installed, a mapping that does
    not divide its dimension evenly is dropped (the dim is replicated):
    this is how a 40-expert bank stays replicated on a 16-way model
    axis.  A mesh axis is used at most once.  A tuple-valued rule stays a
    tuple (even of length 1, e.g. ``batch=("data",)``), a string rule a
    string, as in the JAX package.
    """
    rules = rules if rules is not None else (_rules() or {})
    mesh = _mesh()
    sizes = mesh_sizes(mesh) if mesh is not None else None
    used = set()
    out = []
    for i, name in enumerate(axes):
        target = rules.get(name) if name else None
        if target is None:
            out.append(None)
            continue
        tup = (target,) if isinstance(target, str) else tuple(target)
        tup = tuple(t for t in tup if t not in used)
        if not tup:
            out.append(None)
            continue
        if shape is not None and sizes is not None:
            size = 1
            for t in tup:
                size *= sizes[t]
            if shape[i] % size != 0:
                out.append(None)
                continue
        used.update(tup)
        out.append(tup if isinstance(target, (tuple, list)) else
                   (tup[0] if len(tup) == 1 else tup))
    return tuple(out)


def to_placements(spec: Spec, mesh) -> tuple:
    """DTensor placements (one per mesh dim, in mesh order) for ``spec``:
    ``Shard(d)`` on every mesh axis that tensor dim ``d`` names, else
    ``Replicate()``.  A dim split over several mesh axes must name them
    in mesh order (``("pod", "data")``), the order DTensor splits in."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    dims = {}
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        group = (entry,) if isinstance(entry, str) else tuple(entry)
        order = [names.index(a) for a in group]
        if order != sorted(order):
            raise ValueError(f"spec entry {entry!r} is not in mesh order "
                             f"{tuple(names)}")
        for a in group:
            dims[a] = d
    return tuple(Shard(dims[n]) if n in dims else Replicate() for n in names)


def get_rule(name: str, default=None):
    """Read a (non-axis) entry from the active rule set: implementation
    switches such as ``moe_impl`` and ``attn_ckpt`` that the perf
    overrides toggle per (arch, shape)."""
    rules = _rules()
    if rules is None:
        return default
    return rules.get(name, default)


def active_mesh():
    return _mesh()


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def hint(x, *axes: Optional[str]):
    """Redistribute a DTensor to the placements of its logical ``axes``
    (leading dims may be left out); the identity on a plain tensor or
    with no rules or mesh installed."""
    rules = _rules()
    mesh = _mesh()
    if rules is None or mesh is None or not is_dtensor(x):
        return x
    if x.ndim != len(axes):
        if x.ndim > len(axes):
            axes = (None,) * (x.ndim - len(axes)) + tuple(axes)
        else:
            return x
    placements = to_placements(logical_to_spec(axes, rules, x.shape),
                               x.device_mesh)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(x.device_mesh, placements)


def zeros(shape, dtype, device, *axes: Optional[str]):
    """Zeros of the global ``shape`` as a DTensor placed by its logical
    ``axes`` on the active mesh, each rank allocating only its shard on
    ``device``; a plain tensor with no rules or mesh installed."""
    import torch
    mesh = _mesh()
    if _rules() is None or mesh is None:
        return torch.zeros(shape, dtype=dtype, device=device)
    from torch.distributed.tensor import DTensor, Shard
    placements = to_placements(logical_to_spec(axes, shape=shape), mesh)
    local = list(shape)
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            local[p.dim] //= mesh.shape[i]
    t = torch.zeros(local, dtype=dtype, device=device)
    # the global strides of a contiguous tensor, by arithmetic: a meta
    # tensor of the global shape would be charged by a memory count
    stride, step = [], 1
    for n in reversed(shape):
        stride.insert(0, step)
        step *= max(n, 1)
    return DTensor.from_local(t, mesh, placements, run_check=False,
                              shape=torch.Size(shape), stride=tuple(stride))
