"""Production mesh construction.

The port of ``repro.launch.mesh``.  Single pod: 256 chips as
(data=16, model=16).  Multi-pod: 512 chips as (pod=2, data=16,
model=16), the ``pod`` axis carrying pure data parallelism.  A mesh is a
``DeviceMesh`` over the default process group, which the caller sets up:
NCCL ranks on cards, or the dry run's fake group (``launch.dryrun``).

Functions, not module-level constants: importing this module touches no
process group.
"""
from __future__ import annotations

import math

from repro_torch.launch.compat import make_mesh


def make_production_mesh(*, multi_pod: bool = False, shape=None):
    """Default 256-chip pod is (data=16, model=16); the perf overrides
    may re-factor the same chips (e.g. (32, 8) when an arch's head or
    expert counts do not divide 16).  Raises RuntimeError when the world
    has fewer ranks than the mesh needs.  The mesh is cuda-typed, as
    the cards' is; on the dry run's fake group it builds without a card,
    and DTensor then plans NCCL's collectives (on a cpu-typed mesh it
    replaces an all-to-all by an all-gather)."""
    import torch.distributed as dist
    if shape is None:
        shape = (2, 16, 16) if multi_pod else (16, 16)
    elif multi_pod and len(shape) == 2:
        shape = (2, *shape)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have < n:
        raise RuntimeError(
            f"mesh {tuple(shape)} needs {n} ranks, have {have}: run under "
            f"the dry run's fake process group (repro_torch.launch.dryrun "
            f"sets one up) or on {n} cards")
    return make_mesh(shape, axes, device_type="cuda")


def make_host_mesh(model_axis: int = 1):
    """(data, model) mesh over the whole default group: gloo ranks on the
    CPU, NCCL ranks on cards."""
    import torch.distributed as dist
    n = dist.get_world_size()
    if n % model_axis:
        raise ValueError(f"model axis {model_axis} does not divide "
                         f"{n} ranks")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return make_mesh((n // model_axis, model_axis), ("data", "model"),
                     device_type=device_type)
