"""Carry parameters across the two packages as numpy arrays.

The layouts are the same in both (conv ``(O, C, K, K)``, dense
``(in, out)``, biases ``(N,)``), so the conversion is a checked copy: it
refuses an array whose dtype is not the one the port computes in, and,
given the graph, a layer, parameter or shape the graph does not have.  An
int8 ``QTensor`` (any object with ``q``, ``scale`` and ``axis``) crosses
as a :class:`~repro_torch.core.quantize.QTensor`.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.core.graph import Graph
from repro_torch.core.quantize import QTensor


def _checked(arr, dtype, where: str, shape=None) -> np.ndarray:
    arr = np.asarray(arr)
    if arr.dtype != dtype:
        raise TypeError(f"{where}: dtype {arr.dtype}, expected {dtype}")
    if shape is not None and tuple(arr.shape) != tuple(shape):
        raise ValueError(f"{where}: shape {arr.shape}, expected {shape}")
    return arr


def _expected_shapes(graph: Graph) -> Dict[str, Dict[str, tuple]]:
    params = graph.init_params(torch.Generator().manual_seed(0))
    return {layer: {k: tuple(v.shape) for k, v in p.items()}
            for layer, p in params.items()}


def params_from_numpy(np_params: Dict[str, Dict[str, Any]], device,
                      graph: Optional[Graph] = None):
    """{layer: {name: array | QTensor-like}} -> the port's tensors on
    ``device``.  Plain arrays must be float32; a QTensor's ``q`` int8 and
    ``scale`` float32.  With ``graph``, layers, names and shapes must be
    exactly the graph's."""
    expected = _expected_shapes(graph) if graph is not None else None
    if expected is not None and set(np_params) != set(expected):
        raise ValueError(f"layers {sorted(np_params)} != graph's "
                         f"{sorted(expected)}")
    out = {}
    for layer, group in np_params.items():
        want = expected[layer] if expected is not None else {}
        if expected is not None and set(group) != set(want):
            raise ValueError(f"{layer}: params {sorted(group)} != "
                             f"{sorted(want)}")
        out[layer] = {}
        for name, v in group.items():
            where = f"{layer}/{name}"
            if all(hasattr(v, a) for a in ("q", "scale", "axis")):
                q = _checked(v.q, np.int8, where + "#q", want.get(name))
                axis = int(v.axis) % q.ndim
                scale = _checked(v.scale, np.float32, where + "#scale",
                                 (q.shape[axis],))
                out[layer][name] = QTensor(
                    torch.tensor(q, device=device),
                    torch.tensor(scale, device=device), axis)
            else:
                arr = _checked(v, np.float32, where, want.get(name))
                out[layer][name] = torch.tensor(arr, device=device)
    return out


def params_to_numpy(params) -> Dict[str, Dict[str, Any]]:
    """The reverse: tensors -> float32 numpy arrays; a QTensor -> a
    QTensor holding numpy arrays."""
    def conv(v):
        if isinstance(v, QTensor):
            return QTensor(v.q.detach().cpu().numpy(),
                           v.scale.detach().cpu().numpy(), v.axis)
        return v.detach().cpu().numpy()
    return {layer: {k: conv(v) for k, v in group.items()}
            for layer, group in params.items()}
