"""Checkpointing: train state <-> files, transformers <-> model-store
artifacts.

The port of ``repro.checkpoint.ckpt``.  ``save_train_state`` writes the
reference's layout (``params.npz``, ``opt_m.npz``, ``opt_v.npz``,
``opt_step.json``, ``metadata.json``, keys flattened as the model store
flattens them), so a state saved by either package restores in the
other.  A published spec is ``dataclasses.asdict`` of the config under
the same format tag, so an artifact published by either package loads in
the other.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.modelstore import (ModelStore, flatten_params,
                                         unflatten_params)
from repro_torch.optim.adamw import AdamWState

FORMAT = "repro-archconfig-v1"


def save_train_state(path, params, opt_state: Optional[AdamWState] = None,
                     metadata: Optional[Dict[str, Any]] = None):
    """Params (and the optimizer's m, v and step) as npz files under
    ``path``; tensors are copied to the host."""
    path = pathlib.Path(path)
    path.mkdir(parents=True, exist_ok=True)
    np.savez(path / "params.npz", **flatten_params(params))
    if opt_state is not None:
        np.savez(path / "opt_m.npz", **flatten_params(opt_state.m))
        np.savez(path / "opt_v.npz", **flatten_params(opt_state.v))
        (path / "opt_step.json").write_text(
            json.dumps({"step": int(opt_state.step)}))
    (path / "metadata.json").write_text(json.dumps(metadata or {}))
    return path


def restore_train_state(path) -> Tuple[Any, Optional[AdamWState],
                                       Dict[str, Any]]:
    """(params, optimizer state or None, metadata) as CPU tensors."""
    path = pathlib.Path(path)
    params = unflatten_params(dict(np.load(path / "params.npz")))
    opt_state = None
    if (path / "opt_m.npz").exists():
        m = unflatten_params(dict(np.load(path / "opt_m.npz")))
        v = unflatten_params(dict(np.load(path / "opt_v.npz")))
        step = json.loads((path / "opt_step.json").read_text())["step"]
        opt_state = AdamWState(torch.tensor(step, dtype=torch.int32), m, v)
    metadata = json.loads((path / "metadata.json").read_text())
    return params, opt_state, metadata


def publish_checkpoint(store: ModelStore, name: str, cfg: ArchConfig, params,
                       *, metadata: Optional[Dict[str, Any]] = None,
                       int8: bool = False, version: Optional[str] = None):
    """Publish a transformer into the model store."""
    spec = {"format": FORMAT, "arch": dataclasses.asdict(cfg),
            "metadata": metadata or {}}
    return store.publish(name, spec, params, kind="transformer",
                         int8=int8, version=version)


def load_published(store: ModelStore, name: str,
                   version: Optional[str] = None):
    """(cfg, params as fp32 CPU tensors, record) of a published model."""
    rec = store.get(name, version)
    spec = rec.load_spec()
    if spec.get("format") != FORMAT:
        raise ValueError(f"{name}: spec format {spec.get('format')!r}, "
                         f"expected {FORMAT!r}")
    return ArchConfig(**spec["arch"]), rec.load_params(), rec
