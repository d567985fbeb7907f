"""Torch-version shims for the launch layer.

The port of ``repro.launch.compat``.  The DTensor API moved between torch
releases:

  * ``local_map`` (the twin of ``shard_map``) lives in
    ``torch.distributed.tensor.experimental`` from 2.5 on, in
    ``torch.distributed._tensor.experimental`` before, and took
    ``in_grad_placements`` only from 2.7 on.
  * ``DeviceMesh`` takes ``mesh_dim_names`` everywhere, but building one
    over a subset of the world's ranks needs the explicit constructor.

Everything in ``repro_torch`` that builds a mesh or a ``local_map`` goes
through these helpers.
"""
from __future__ import annotations

import inspect
import math
from dataclasses import dataclass
from typing import Sequence, Tuple


def make_mesh(shape: Sequence[int], axes: Sequence[str], *,
              device_type: str, devices=None):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the default
    process group: its first prod(shape) ranks, or ``devices`` (a list of
    ranks) in row-major order."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
    shape, axes = tuple(shape), tuple(axes)
    if devices is None:
        import torch.distributed as dist
        if dist.get_world_size() == math.prod(shape):
            return init_device_mesh(device_type, shape,
                                    mesh_dim_names=axes)
        devices = range(math.prod(shape))
    ranks = torch.tensor(list(devices), dtype=torch.int).reshape(shape)
    return DeviceMesh(device_type, ranks, mesh_dim_names=axes)


def _local_map():
    try:
        from torch.distributed.tensor.experimental import local_map
    except ImportError:
        from torch.distributed._tensor.experimental import local_map
    return local_map


def shard_map(f, *, mesh, in_specs, out_specs, in_grad_specs=None):
    """``f`` on each rank's local shards, the twin of ``jax.shard_map``
    over ``local_map``.  Specs are ``sharding_hints`` specs (one entry
    per tensor dim) or None for a non-tensor argument, and ``out_specs``
    is one spec, or a list of them for several outputs; the inputs are
    redistributed to ``in_specs`` first.  ``in_grad_specs`` gives the
    placements of the inputs' gradients (default ``in_specs``); an
    entry may be a tuple of DTensor placements instead of a spec, which
    is how a ``Partial()`` gradient is named.  On plain tensors (no
    DTensor argument) ``f`` runs as it is."""
    from torch.distributed.tensor import Placement

    from repro_torch.sharding_hints import to_placements

    def place(spec):
        if spec is None:
            return None
        if spec and all(isinstance(p, Placement) for p in spec):
            return tuple(spec)
        return to_placements(spec, mesh)

    in_pl = tuple(place(s) for s in in_specs)
    # local_map reads a tuple as one placement list per output and a
    # list as the placements of the one output
    out_pl = tuple(place(s) for s in out_specs) \
        if isinstance(out_specs, list) else list(place(out_specs))
    local_map = _local_map()
    kw = dict(out_placements=out_pl, in_placements=in_pl,
              device_mesh=mesh, redistribute_inputs=True)
    if "in_grad_placements" in inspect.signature(local_map).parameters:
        kw["in_grad_placements"] = tuple(
            place(s) for s in (in_grad_specs or in_specs))
    elif in_grad_specs is not None and in_grad_specs != in_specs:
        raise NotImplementedError(
            "this torch's local_map takes no in_grad_placements")
    return local_map(f, **kw)


@dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes with no process group: enough for
    ``sharding_hints.logical_to_spec``'s divisor guard on a production
    mesh without its ranks (the twin of ``jax.sharding.AbstractMesh``)."""
    shape: Tuple[int, ...]
    mesh_dim_names: Tuple[str, ...]


def abstract_mesh(axis_sizes: Sequence[int], axis_names: Sequence[str]):
    return AbstractMesh(tuple(int(s) for s in axis_sizes), tuple(axis_names))
