"""Model registry: family -> module, plus uniform entry points.

The port of ``repro.models``.  Ported families: the dense transformer
(``dense`` and ``vlm``, the serving path) and the paper's CNNs (``cnn``).
The others raise ``NotImplementedError`` naming the ROADMAP item that
ports them.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import common

# family -> the ROADMAP item (queue A) that ports it
_NOT_PORTED = {"moe": "A12 (models/moe.py)", "ssm": "A12 (models/rwkv6.py)",
               "hybrid": "A12 (models/rglru.py)",
               "audio": "A12 (models/encdec.py)"}


def get_module(cfg: ArchConfig):
    fam = cfg.family
    if fam in ("dense", "vlm"):
        from repro_torch.models import transformer
        return transformer
    if fam == "cnn":
        from repro_torch.models import cnn
        return cnn
    if fam in _NOT_PORTED:
        raise NotImplementedError(
            f"family {fam!r} is not ported yet: ROADMAP {_NOT_PORTED[fam]}")
    raise KeyError(f"unknown family {fam!r}")


def param_template(cfg: ArchConfig):
    return get_module(cfg).param_template(cfg)


def init_params(cfg: ArchConfig, generator: torch.Generator,
                dtype=torch.float32, device="cpu"):
    """Random parameters at the JAX package's scales, drawn from
    ``generator`` (the draws differ from ``jax.random``: tests that
    compare the packages make their weights once in numpy)."""
    return common.init_params(param_template(cfg), generator, dtype, device)


def param_count(cfg: ArchConfig, active_only: bool = False) -> int:
    n = common.param_count_of(param_template(cfg))
    if active_only and cfg.is_moe:
        d, f, L, E, k = (cfg.d_model, cfg.d_ff, cfg.num_layers,
                         cfg.num_experts, cfg.experts_per_token)
        n = n - L * E * 3 * d * f + L * k * 3 * d * f
    return n
