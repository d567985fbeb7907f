"""Transformer checkpoints <-> model-store artifacts.

The port of ``publish_checkpoint`` and ``load_published`` of
``repro.checkpoint.ckpt``: the spec is ``dataclasses.asdict`` of the
config under the same format tag, so an artifact published by either
package loads in the other.  The train-state functions wait for the
training slice (they need the optimizer).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

from repro_torch.configs.base import ArchConfig
from repro_torch.core.modelstore import ModelStore

FORMAT = "repro-archconfig-v1"


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
