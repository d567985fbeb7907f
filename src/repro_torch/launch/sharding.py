"""Sharding rule sets: logical axis names -> mesh axes, per workload kind.

The port of ``repro.launch.sharding``.  The models name the axes of
their parameters (``P`` templates) and activations (``hint``) logically;
these tables decide placement.  The divisor check in
``sharding_hints.logical_to_spec`` drops any mapping that does not
divide its dimension (granite's 40-expert bank on a 16-way model axis
falls back to per-expert FFN sharding).  Placement is a DTensor: a tree
of parameters becomes a tree of DTensors by :func:`shard_params`.

``PERF_OVERRIDES`` is the JAX package's table, entry for entry (its
comments there give each entry's hypothesis and measured effect on the
TPU mesh).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

from repro_torch.models.common import map_template
from repro_torch.sharding_hints import logical_to_spec, to_placements

MeshAxes = Union[None, str, Tuple[str, ...]]


def rules_for(kind: str, *, multi_pod: bool = False,
              overrides: Optional[Dict[str, MeshAxes]] = None
              ) -> Dict[str, MeshAxes]:
    batch = ("pod", "data") if multi_pod else ("data",)
    rules: Dict[str, MeshAxes] = {
        # --- activations ---
        "batch": batch,
        "seq": None,
        "heads": "model",
        "kv_heads": "model",
        "ff": "model",
        "embed": None,
        "vocab_act": "model",
        "experts_act": "model",
        "cache_seq": None,
        # --- parameters ---
        "tp_heads": "model",
        "tp_kv": "model",
        "tp_ff": "model",
        "tp_vocab": "model",
        "experts": "model",
        "fsdp": "data",
    }
    if kind == "decode":
        # the KV cache is the big tensor: shard its sequence dim over the
        # model axis (head-count agnostic); tp_kv stays for the weights
        rules["cache_seq"] = "model"
    elif kind not in ("train", "prefill"):
        raise ValueError(kind)
    if overrides:
        rules.update(overrides)
    return rules


def param_shardings(template, rules, mesh):
    """Tree of DTensor placements for a template (``P`` leaves)."""
    return map_template(
        lambda p: to_placements(logical_to_spec(p.axes, rules, p.shape),
                                mesh), template)


def struct_shardings(structs, axes_tree, rules, mesh):
    """Placements for a tree of tensors (meta or real) and the matching
    tree of logical-axis tuples."""
    if isinstance(structs, dict):
        return {k: struct_shardings(structs[k], axes_tree[k], rules, mesh)
                for k in structs}
    return to_placements(logical_to_spec(axes_tree, rules, structs.shape),
                         mesh)


def replicated(mesh):
    from torch.distributed.tensor import Replicate
    return (Replicate(),) * mesh.ndim


def distribute(tree, placements, mesh):
    """A tree of tensors -> a tree of DTensors with ``placements`` (a
    matching tree).  A meta tensor stays meta: its local shard is made
    with no storage."""
    from torch.distributed.tensor import distribute_tensor
    if isinstance(tree, dict):
        return {k: distribute(tree[k], placements[k], mesh) for k in tree}
    return distribute_tensor(tree, mesh, list(placements))


def shard_params(params, template, rules, mesh):
    """The parameter tree as DTensors placed by ``rules`` on ``mesh``."""
    return distribute(params, param_shardings(template, rules, mesh), mesh)


# ---------------------------------------------------------------------------
# Perf hillclimb overrides, keyed by (arch, shape): the JAX package's.
# ---------------------------------------------------------------------------

PERF_OVERRIDES: Dict[Tuple[str, str], Dict[str, MeshAxes]] = {
    # hillclimb 1: in the JAX package the dense MoE's data-dependent
    # scatter replicates the global (T*k, d) token rows; the port's dense
    # body keeps its buffer and rows sharded (models/moe.py).  a2a
    # dispatches with a capacity per token shard and moves k*T*d bytes
    ("qwen3-moe-235b-a22b", "train_4k"): {"moe_impl": "a2a", "tp_ff": None,
                                          "attn_ckpt": True},
    ("qwen3-moe-235b-a22b", "prefill_32k"): {"moe_impl": "a2a",
                                             "tp_ff": None},
    # hillclimb 2: 24 heads / 40 experts vs a 16-way model axis; the same
    # 256 chips as (data=32, model=8) shard both
    ("granite-moe-3b-a800m", "prefill_32k"): {"moe_impl": "a2a",
                                              "tp_ff": None,
                                              "_mesh_shape": (32, 8)},
    ("granite-moe-3b-a800m", "train_4k"): {"moe_impl": "local",
                                           "experts": None, "tp_ff": None},
    # carry-over: rwkv6's 40 wkv heads, same mesh fix (train_4k only)
    ("rwkv6-3b", "train_4k"): {"_mesh_shape": (32, 8)},
}


def rules_for_pair(arch: str, shape: str, kind: str, *,
                   multi_pod: bool = False, optimized: bool = False
                   ) -> Dict[str, MeshAxes]:
    ov = PERF_OVERRIDES.get((arch, shape)) if optimized else None
    return rules_for(kind, multi_pod=multi_pod, overrides=ov)
