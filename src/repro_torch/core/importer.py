"""Caffe-like JSON model interchange — the paper's importer (section 3).

The port of ``repro.core.importer`` with the ``deeplearningkit-json-v1``
schema unchanged, so a document written by either package imports into
the other.  A layer list carries Caffe type names and layer params, with
weights inline (lists) or in a sidecar .npz:

    {"name": "nin-cifar10", "format": "deeplearningkit-json-v1",
     "input_dim": [3, 32, 32],
     "layers": [
        {"type": "Convolution", "name": "conv1",
         "convolution_param": {"num_output": 192, "kernel_size": 5,
                               "stride": 1, "pad": 2}},
        {"type": "ReLU", "name": "relu1"}, ...]}

Each op in ``repro_torch.core.ops.REGISTRY`` declares its Caffe type
name and attr encode/decode hooks; nothing is hardcoded here.
"""
from __future__ import annotations

import json
import pathlib
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.graph import Graph, Layer
from repro_torch.core.ops import REGISTRY


def to_caffe_json(graph: Graph, params=None, *, inline_weights: bool = False
                  ) -> Tuple[Dict[str, Any], Dict[str, np.ndarray]]:
    """Returns (json_dict, weight_arrays).  Weights go inline (lists) when
    ``inline_weights`` else into the sidecar dict (stored as .npz)."""
    layers = []
    weights: Dict[str, np.ndarray] = {}
    for l in graph.layers:
        spec = REGISTRY.op(l.kind)
        if not spec.caffe_type:
            raise ValueError(f"op {l.kind!r} has no Caffe interchange type")
        entry = {"type": spec.caffe_type, "name": l.name}
        if spec.to_caffe is not None:
            entry.update(spec.to_caffe(l.attrs))
        if params is not None and l.name in params:
            for pname, t in params[l.name].items():
                arr = t.detach().cpu().numpy()
                if inline_weights:
                    entry.setdefault("blobs", {})[pname] = {
                        "shape": list(arr.shape),
                        "data": arr.ravel().tolist()}
                else:
                    weights[f"{l.name}/{pname}"] = arr
        layers.append(entry)
    doc = {"name": graph.name, "format": "deeplearningkit-json-v1",
           "input_dim": list(graph.input_shape), "layers": layers}
    return doc, weights


def from_caffe_json(doc: Dict[str, Any],
                    weights: Optional[Dict[str, np.ndarray]] = None
                    ) -> Tuple[Graph, Dict[str, Dict[str, torch.Tensor]]]:
    """Returns (graph, params) with params as CPU tensors."""
    layers = []
    params: Dict[str, Dict[str, torch.Tensor]] = {}
    for entry in doc["layers"]:
        t, name = entry["type"], entry["name"]
        spec = REGISTRY.by_caffe_type(t)
        attrs = spec.from_caffe(entry) if spec.from_caffe is not None else {}
        layers.append(Layer(spec.kind, name, attrs))
        blob = entry.get("blobs")
        if blob:
            params[name] = {
                pn: torch.tensor(b["data"], dtype=torch.float32)
                .reshape(b["shape"])
                for pn, b in blob.items()}
    if weights:
        for key, arr in weights.items():
            lname, pname = key.split("/", 1)
            params.setdefault(lname, {})[pname] = \
                torch.from_numpy(np.array(arr))
    graph = Graph(doc["name"], tuple(doc["input_dim"]), layers)
    graph.shapes()  # resolve in_channels / in_features
    return graph, params


def save_model(path, graph: Graph, params, *, inline_weights=False):
    """Write <path>.json (+ <path>.npz when weights are sidecar)."""
    path = pathlib.Path(path)
    doc, weights = to_caffe_json(graph, params, inline_weights=inline_weights)
    path.with_suffix(".json").write_text(json.dumps(doc))
    if weights:
        np.savez(path.with_suffix(".npz"), **weights)
    return path.with_suffix(".json")


def load_model(path):
    path = pathlib.Path(path)
    doc = json.loads(path.with_suffix(".json").read_text())
    npz = path.with_suffix(".npz")
    weights = None
    if npz.exists():
        with np.load(npz) as z:
            weights = dict(z)
    return from_caffe_json(doc, weights)
