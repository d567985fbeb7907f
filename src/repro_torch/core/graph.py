"""Layer-graph execution engine — the DeepLearningKit network runtime.

The port of ``repro.core.graph``.  The paper's Swift layer builds a
convolutional-network pipeline from an imported (Caffe->JSON) description
and dispatches one Metal shader per layer; here

    spec (list of layer dicts)  ->  Graph  ->  compiled_apply(params, x)

dispatches one kernel per layer.  Op semantics live in the op registry
(``repro_torch.core.ops``); every ``Graph`` method is a generic loop over
its :class:`~repro_torch.core.ops.OpSpec` entries.

Backend selection is a per-op name lookup: ``apply(..., backend="cuda")``
resolves each op's implementation from its backend table (``ref`` |
``cuda``), falling back to ``ref`` when an op has no such backend.  A dict
selects per kind (``backend={"conv": "ref", "default": "cuda"}``), and a
layer can pin its own via ``attrs["backend"]``.

``memory_plan`` is a liveness scan: each activation is live until its last
consumer, freed buffers go to a free list, and ``inplace`` ops reuse their
input slot outright.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.ops import REGISTRY, ApplyContext, OpSpec

Backend = Union[None, str, Dict[str, str]]


@dataclass
class Layer:
    kind: str                 # any kind registered in repro_torch.core.ops
    name: str
    attrs: Dict[str, Any]

    @property
    def spec(self) -> OpSpec:
        return REGISTRY.op(self.kind)

    def out_shape(self, in_shape: Tuple[int, ...]) -> Tuple[int, ...]:
        return tuple(self.spec.shape(self.attrs, tuple(in_shape)))


def _resolve_backend(layer: Layer, backend: Backend) -> Optional[str]:
    if "backend" in layer.attrs:
        return layer.attrs["backend"]
    if isinstance(backend, dict):
        return backend.get(layer.kind, backend.get("default"))
    return backend


class Graph:
    """Sequential layer graph with named-reference edges (residual adds)."""

    def __init__(self, name: str, input_shape: Tuple[int, ...],
                 layers: List[Layer]):
        self.name = name
        self.input_shape = tuple(input_shape)
        self.layers = layers

    # -- construction -------------------------------------------------------

    @classmethod
    def from_spec(cls, spec: Dict[str, Any]) -> "Graph":
        """Build from the compact block spec used in repro_torch.configs."""
        layers: List[Layer] = []
        for i, blk in enumerate(spec["blocks"]):
            kinds = [k for k in blk if k in REGISTRY]
            if len(kinds) != 1:
                raise ValueError(f"unknown block {blk}")
            kind = kinds[0]
            op = REGISTRY.op(kind)
            attrs = op.from_block(blk[kind]) if op.from_block else {}
            layers.append(Layer(kind, f"{kind}{i}", attrs))
        return cls(spec["name"], tuple(spec["input"]), layers)

    # -- shapes / params ----------------------------------------------------

    def _referenced(self) -> Dict[str, int]:
        """layer name -> index of its LAST consuming reference layer."""
        out: Dict[str, int] = {}
        names = {l.name for l in self.layers}
        for j, l in enumerate(self.layers):
            if l.spec.references is None:
                continue
            for src in l.spec.references(l.attrs):
                if src not in names:
                    raise ValueError(
                        f"layer {l.name!r} references unknown layer {src!r}")
                out[src] = j
        return out

    def shapes(self) -> List[Tuple[int, ...]]:
        """Activation shape after every layer (excluding batch dim)."""
        out = []
        s = self.input_shape
        by_name: Dict[str, Tuple[int, ...]] = {}
        for l in self.layers:
            if l.spec.infer is not None:
                l.spec.infer(l.attrs, s)
            if l.spec.references is not None:
                for src in l.spec.references(l.attrs):
                    if by_name.get(src) != s:
                        raise ValueError(
                            f"{l.name!r} adds {src!r} with shape "
                            f"{by_name.get(src)} to activation of shape {s}")
            s = l.out_shape(s)
            by_name[l.name] = s
            out.append(s)
        return out

    def init_params(self, generator: torch.Generator
                    ) -> Dict[str, Dict[str, torch.Tensor]]:
        """Random parameters on the CPU, drawn in layer order."""
        self.shapes()  # resolve inferred attrs (in_channels/in_features/...)
        return {l.name: l.spec.init(generator, l.attrs)
                for l in self.layers if l.spec.init is not None}

    # -- execution ----------------------------------------------------------

    def apply(self, params, x, *, backend: Backend = None,
              trace: Optional[List[torch.Tensor]] = None):
        """x: (B, C, H, W) or (B, F). Returns the network output.

        ``backend`` selects per-op implementations by name: a string
        applies to every op that declares it ("ref" | "cuda"), a dict
        selects per kind with a "default" entry, and ops without the
        requested backend fall back to ``ref``.  ``trace``, when given,
        receives every layer's output in order.
        """
        ctx = ApplyContext()
        save_for = self._referenced()
        for l in self.layers:
            fn = l.spec.backend(_resolve_backend(l, backend))
            x = fn(x, params.get(l.name), l.attrs, ctx)
            if l.name in save_for:
                ctx.saved[l.name] = x
            if trace is not None:
                trace.append(x)
        return x

    def compiled_apply(self, **kw) -> Callable:
        """The pipeline-state object: ``fn(params, x)`` under inference mode."""
        def run(params, x):
            with torch.inference_mode():
                return self.apply(params, x, **kw)
        return run

    # -- analysis -----------------------------------------------------------

    def flops(self, batch: int = 1) -> int:
        """Multiply-add FLOPs (2*MACs) for one forward pass."""
        total = 0
        s = self.input_shape
        for l, o in zip(self.layers, self.shapes()):
            total += l.spec.op_flops(l.attrs, s, o)
            s = o
        return total * batch

    def bytes_moved(self, batch: int = 1, elem: int = 4) -> int:
        """Activation + weight traffic for one pass (no reuse)."""
        total = int(np.prod(self.input_shape)) * elem
        for l, o in zip(self.layers, self.shapes()):
            total += int(np.prod(o)) * elem
            total += l.spec.op_weight_bytes(l.attrs, elem)
        return total * batch

    def memory_plan(self, batch: int = 1, elem: int = 4) -> Dict[str, Any]:
        """Liveness-based buffer-slot assignment.

        Activation i is live from its producing layer until its last
        consumer — layer i+1 for the chain edge, or a later ``add`` that
        references it by name.  Dead buffers return to a free list;
        registry-declared ``inplace`` ops reuse their input slot when the
        input dies at this step.  Chains collapse to two ping-pong slots;
        residual references pin their source buffer until consumed.
        """
        shapes = [self.input_shape] + self.shapes()
        sizes = [int(np.prod(s)) * elem * batch for s in shapes]
        naive = sum(sizes)
        n = len(self.layers)
        ref_last = self._referenced()
        name_to_idx = {l.name: i for i, l in enumerate(self.layers)}
        # last step at which activation i (output of layer i-1; i=0 is the
        # graph input) is read
        last_use = [min(i, n - 1) for i in range(n + 1)]
        for src_name, consumer in ref_last.items():
            i = name_to_idx[src_name] + 1
            last_use[i] = max(last_use[i], consumer)

        slots: List[int] = []                  # slot -> high-water bytes
        free: List[int] = []
        act_slot = [-1] * (n + 1)
        assignment: List[Tuple[str, int, int]] = []

        slots.append(sizes[0])
        act_slot[0] = 0
        for step, l in enumerate(self.layers):
            out_sz = sizes[step + 1]
            in_slot = act_slot[step]
            input_dies = last_use[step] <= step
            if l.spec.inplace and input_dies:
                slot = in_slot
                slots[slot] = max(slots[slot], out_sz)
            else:
                # the op reads its input while writing its output, so the
                # input slot is only released AFTER allocation
                if free:
                    slot = free.pop()
                    slots[slot] = max(slots[slot], out_sz)
                else:
                    slot = len(slots)
                    slots.append(out_sz)
                if input_dies:
                    free.append(in_slot)
            act_slot[step + 1] = slot
            assignment.append((l.name, slot, out_sz))
            # release referenced activations whose last read was this step
            for i in range(step):
                if last_use[i + 1] == step and i + 1 != step:
                    free.append(act_slot[i + 1])
        planned = sum(slots)
        return {
            "naive_bytes": naive,
            "planned_bytes": planned,
            "savings_ratio": naive / max(planned, 1),
            "num_slots": len(slots),
            "assignment": assignment,
        }
