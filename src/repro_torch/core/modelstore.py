"""App Store for Deep Learning Models — section 2 of the paper.

The port of ``repro.core.modelstore``, with the same on-disk layout, so
an artifact published by either package loads in the other:

    <root>/index.json                       global catalog
    <root>/<name>/<version>/manifest.json   hashes, sizes, tags, lineage
    <root>/<name>/<version>/model.json      network description
    <root>/<name>/<version>/weights.npz     parameters (optionally int8)

Nested parameter dicts flatten to ``layer/param`` keys; an int8
:class:`~repro_torch.core.quantize.QTensor` flattens to ``...#q``,
``...#scale`` and ``...#axis``.  ``get`` checks the sha256 of
``weights.npz`` against the manifest.  ``ResidentCache`` keeps parameter
trees resident on the runtime's device.
"""
from __future__ import annotations

import hashlib
import json
import pathlib
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.quantize import QTensor, dequantize_tree, quantize_tree

_SEP = "/"


# -- nested dict <-> flat npz ------------------------------------------------


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def flatten_params(params, prefix="") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    if isinstance(params, QTensor):
        out[prefix + "#q"] = _np(params.q)
        out[prefix + "#scale"] = _np(params.scale)
        out[prefix + "#axis"] = np.asarray(params.axis)
        return out
    if isinstance(params, dict):
        for k, v in params.items():
            if _SEP in str(k):
                raise ValueError(f"key {k!r} contains separator")
            out.update(flatten_params(v, f"{prefix}{k}{_SEP}"))
        return out
    out[prefix.rstrip(_SEP)] = _np(params)
    return out


def unflatten_params(flat: Dict[str, np.ndarray]):
    nested: Dict[str, Any] = {}
    qtensors: Dict[str, Dict[str, np.ndarray]] = {}
    for key, arr in flat.items():
        if "#" in key:
            base, part = key.rsplit("#", 1)
            qtensors.setdefault(base.rstrip(_SEP), {})[part] = arr
            continue
        parts = key.split(_SEP)
        d = nested
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = torch.from_numpy(np.array(arr))
    for base, parts in qtensors.items():
        qt = QTensor(torch.from_numpy(np.array(parts["q"])),
                     torch.from_numpy(np.array(parts["scale"])),
                     int(parts["axis"]))
        d = nested
        keys = base.split(_SEP)
        for p in keys[:-1]:
            d = d.setdefault(p, {})
        d[keys[-1]] = qt
    return nested


@dataclass
class ModelRecord:
    name: str
    version: str
    kind: str
    path: pathlib.Path
    manifest: Dict[str, Any]

    def load_spec(self) -> Dict[str, Any]:
        return json.loads((self.path / "model.json").read_text())

    def load_params(self, dequantize: bool = True, dtype=torch.float32):
        """Parameters as CPU tensors (int8 artifacts dequantized)."""
        with np.load(self.path / "weights.npz") as npz:
            flat = dict(npz)
        params = unflatten_params(flat)
        if dequantize:
            params = dequantize_tree(params, dtype)
        return params


class ModelStore:
    def __init__(self, root):
        self.root = pathlib.Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self._index_path = self.root / "index.json"
        if not self._index_path.exists():
            self._write_index({"models": {}})

    # -- catalog --

    def _read_index(self):
        return json.loads(self._index_path.read_text())

    def _write_index(self, idx):
        self._index_path.write_text(json.dumps(idx, indent=1, sort_keys=True))

    def list_models(self) -> Dict[str, List[str]]:
        return {k: sorted(v["versions"])
                for k, v in self._read_index()["models"].items()}

    # -- publish / fetch --

    def publish(self, name: str, spec: Dict[str, Any], params, *,
                kind: str = "cnn", version: Optional[str] = None,
                tags: Optional[List[str]] = None,
                int8: bool = False) -> ModelRecord:
        idx = self._read_index()
        entry = idx["models"].setdefault(
            name, {"versions": [], "latest": None})
        version = version or f"v{len(entry['versions']) + 1}"
        if version in entry["versions"]:
            raise ValueError(f"{name}:{version} already published")
        path = self.root / name / version
        path.mkdir(parents=True, exist_ok=True)
        if int8:
            params = quantize_tree(params)
        flat = flatten_params(params)
        np.savez(path / "weights.npz", **flat)
        (path / "model.json").write_text(json.dumps(spec))
        wbytes = (path / "weights.npz").stat().st_size
        sha = hashlib.sha256((path / "weights.npz").read_bytes()).hexdigest()
        manifest = {
            "name": name, "version": version, "kind": kind,
            "tags": tags or [], "int8": int8,
            "weights_bytes": wbytes, "weights_sha256": sha,
            "num_tensors": len(flat),
            "published_unix": time.time(),
        }
        (path / "manifest.json").write_text(json.dumps(manifest, indent=1))
        entry["versions"].append(version)
        entry["latest"] = version
        entry["kind"] = kind
        self._write_index(idx)
        return ModelRecord(name, version, kind, path, manifest)

    def get(self, name: str, version: Optional[str] = None) -> ModelRecord:
        idx = self._read_index()
        if name not in idx["models"]:
            raise KeyError(f"model {name!r} not in store "
                           f"(have {sorted(idx['models'])})")
        entry = idx["models"][name]
        version = version or entry["latest"]
        path = self.root / name / version
        manifest = json.loads((path / "manifest.json").read_text())
        self.verify(path, manifest)
        return ModelRecord(name, version, manifest["kind"], path, manifest)

    @staticmethod
    def verify(path: pathlib.Path, manifest: Dict[str, Any]):
        sha = hashlib.sha256((path / "weights.npz").read_bytes()).hexdigest()
        if sha != manifest["weights_sha256"]:
            raise IOError(f"checksum mismatch for {path} — corrupt artifact")


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


class ResidentCache:
    """LRU cache of device-resident parameter trees (section 2's rapid
    model switching: 'intelligently and very rapidly load them from SSD
    into GPU accessible RAM')."""

    def __init__(self, store: ModelStore, capacity: int = 2,
                 device: torch.device = torch.device("cpu")):
        self.store = store
        self.capacity = capacity
        self.device = torch.device(device)
        self._cache: "OrderedDict[Tuple[str, str], Any]" = OrderedDict()
        self.hits = 0
        self.misses = 0

    def get(self, name: str, version: Optional[str] = None):
        rec = self.store.get(name, version)
        key = (rec.name, rec.version)
        if key in self._cache:
            self.hits += 1
            self._cache.move_to_end(key)
            return self._cache[key]
        self.misses += 1
        spec = rec.load_spec()
        params = _to_device(rec.load_params(), self.device)
        value = (rec, spec, params)
        self._cache[key] = value
        while len(self._cache) > self.capacity:
            self._cache.popitem(last=False)   # evict LRU
        return value

    @property
    def resident(self):
        return list(self._cache)
