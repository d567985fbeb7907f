"""Architecture configuration registry (the CNN part of ``repro.configs``).

The port keeps its own copy of the config schema so that it imports
nothing of the JAX package.  Only the two CNN configs of the paper's
inference path are registered here.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict


@dataclass(frozen=True)
class ArchConfig:
    """The fields of ``repro.configs.base.ArchConfig`` that the CNN configs
    set; the transformer fields arrive with the slice that uses them."""
    name: str
    family: str                    # cnn
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    dtype: str = "bfloat16"
    source: str = ""


_REGISTRY: Dict[str, Callable[[], ArchConfig]] = {}


def register(name: str):
    def deco(fn: Callable[[], ArchConfig]):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_config(name: str) -> ArchConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def _ensure_loaded():
    # import every config module so its @register runs
    from repro_torch.configs import lenet_mnist, nin_cifar10  # noqa: F401
