"""Model registry: family -> module, plus uniform entry points.

The port of ``repro.models``.  Every family of the JAX package: the
dense transformer (``dense`` and ``vlm``: training through ``loss_fn`` and
serving), RWKV-6 (``ssm``: serving, and training through ``loss_fn`` on
its plain chunked WKV), the mixture-of-experts decoder (``moe``: serving
and training), the Griffin hybrid (``hybrid``: serving and training), the
Whisper-style encoder-decoder (``audio``: serving and training; its
``loss_fn`` batch carries ``frames``) and the paper's CNNs (``cnn``).
``input_specs`` describes a shape's inputs for the dry run
(``launch.dryrun``).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.models import common


def get_module(cfg: ArchConfig):
    fam = cfg.family
    if fam in ("dense", "vlm"):
        from repro_torch.models import transformer
        return transformer
    if fam == "moe":
        from repro_torch.models import moe
        return moe
    if fam == "ssm":
        from repro_torch.models import rwkv6
        return rwkv6
    if fam == "hybrid":
        from repro_torch.models import rglru
        return rglru
    if fam == "audio":
        from repro_torch.models import encdec
        return encdec
    if fam == "cnn":
        from repro_torch.models import cnn
        return cnn
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


def effective_window(cfg: ArchConfig, shape: ShapeSpec) -> int:
    """Window used for a given input shape (0 = full attention)."""
    if shape.name == "long_500k" and cfg.sliding_window:
        return cfg.sliding_window
    return 0


def cache_len(cfg: ArchConfig, shape: ShapeSpec) -> int:
    """Decode cache slots for ``shape``: the hybrid's local window caps
    its rings; otherwise the window, or the whole sequence."""
    w = effective_window(cfg, shape)
    if cfg.family == "hybrid":
        return min(shape.seq_len, cfg.local_window)
    return min(shape.seq_len, w) if w else shape.seq_len


def input_specs(cfg: ArchConfig, shape: ShapeSpec,
                dtype=torch.bfloat16) -> Dict[str, Any]:
    """Meta-tensor stand-ins (shape and dtype, no storage) and logical
    axes for every model input of ``shape``: 'batch' and 'batch_axes',
    and for decode 'cache', 'cache_axes' and 'pos', the JAX package's
    keys (its ``ShapeDtypeStruct`` leaves are meta tensors here)."""
    B, S = shape.global_batch, shape.seq_len
    tok = lambda s: torch.empty(s, dtype=torch.int32, device="meta")
    if shape.kind in ("train", "prefill"):
        args = {"tokens": tok((B, S))}
        axes = {"tokens": ("batch", None)}
        if shape.kind == "train":
            args["labels"] = tok((B, S))
            axes["labels"] = ("batch", None)
        if cfg.family == "audio":
            args["frames"] = torch.empty((B, cfg.encoder_seq, cfg.d_model),
                                         dtype=dtype, device="meta")
            axes["frames"] = ("batch", None, None)
        return {"batch": args, "batch_axes": axes}
    # decode: ONE new token against a cache of cache_len
    cache, cache_axes = get_module(cfg).cache_spec(
        cfg, B, cache_len(cfg, shape), dtype)
    return {
        "batch": {"token": tok((B, 1))},
        "batch_axes": {"token": ("batch", None)},
        "cache": common.meta_tree(cache),
        "cache_axes": cache_axes,
        "pos": tok(()),
    }
