"""Carry parameters across the two packages as numpy arrays.

The layouts are the same in both (conv ``(O, C, K, K)``, dense
``(in, out)``, biases ``(N,)``; the transformer's nested tree with its
layers stacked along a leading L axis, tied or separate embeddings), so
the conversion is a checked copy: it refuses an array whose dtype is not
the one the port computes in, and, given the graph or the transformer
config, a key, nesting or shape the model does not have.  An int8
``QTensor`` (any object with ``q``, ``scale`` and ``axis``) crosses as a
:class:`~repro_torch.core.quantize.QTensor`.
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


def _expected_shapes(graph: Optional[Graph], cfg) -> Optional[Dict[str, Any]]:
    """The model's tree of shapes, or None when neither is given."""
    if graph is not None:
        params = graph.init_params(torch.Generator().manual_seed(0))
        return {layer: {k: tuple(v.shape) for k, v in p.items()}
                for layer, p in params.items()}
    if cfg is not None:
        from repro_torch import models
        from repro_torch.models.common import map_template
        return map_template(lambda p: tuple(p.shape),
                            models.param_template(cfg))
    return None


def _is_qtensor(v) -> bool:
    return all(hasattr(v, a) for a in ("q", "scale", "axis"))


def _from_numpy(v, want, where: str, device):
    if isinstance(v, dict):
        if want is not None and (not isinstance(want, dict)
                                 or set(v) != set(want)):
            raise ValueError(f"{where or 'params'}: keys {sorted(v)} != "
                             f"the model's {sorted(want) if isinstance(want, dict) else want}")
        return {k: _from_numpy(x, None if want is None else want[k],
                               f"{where}/{k}" if where else k, device)
                for k, x in v.items()}
    if isinstance(want, dict):
        raise ValueError(f"{where}: a leaf where the model has {sorted(want)}")
    if _is_qtensor(v):
        q = _checked(v.q, np.int8, where + "#q", want)
        axis = int(v.axis) % q.ndim
        scale = _checked(v.scale, np.float32, where + "#scale",
                         (q.shape[axis],))
        return QTensor(torch.tensor(q, device=device),
                       torch.tensor(scale, device=device), axis)
    return torch.tensor(_checked(v, np.float32, where, want), device=device)


def params_from_numpy(np_params: Dict[str, Any], device,
                      graph: Optional[Graph] = None, cfg=None):
    """A nested dict of arrays (or QTensor-likes) -> the port's tensors
    on ``device``.  Plain arrays must be float32; a QTensor's ``q`` int8
    and ``scale`` float32.  With ``graph`` (a CNN) or ``cfg`` (a
    transformer's ArchConfig) the keys, nesting and shapes must be
    exactly the model's."""
    return _from_numpy(np_params, _expected_shapes(graph, cfg), "", device)


def params_to_numpy(params) -> Dict[str, Any]:
    """The reverse: tensors -> numpy arrays; a QTensor -> a QTensor
    holding numpy arrays."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    if isinstance(params, QTensor):
        return QTensor(params.q.detach().cpu().numpy(),
                       params.scale.detach().cpu().numpy(), params.axis)
    return params.detach().cpu().numpy()
