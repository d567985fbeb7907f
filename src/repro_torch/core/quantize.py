"""Reduced-precision weights: symmetric per-channel int8 over parameter trees.

The port of ``repro.core.quantize``: what the model store and the int8
KV cache use, and the reconstruction error.  The arithmetic is the JAX
package's, step for step, so the int8 payloads and scales of a published
artifact are equal in both packages:
``scale = max(absmax / 127, SCALE_EPS)`` in fp32, ``q = clip(round(x /
scale), -127, 127)`` with round-half-to-even (``torch.round`` and
``jnp.round`` agree).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

# Scales are clamped to this floor everywhere a scale is computed: an
# all-zero channel would otherwise yield scale 0, and any path that later
# divides by the scale would emit NaN/inf.
SCALE_EPS = 1e-12


@dataclass
class QTensor:
    """Per-channel symmetric int8 tensor. scale is along ``axis``."""
    q: torch.Tensor          # int8, same shape as original
    scale: torch.Tensor      # f32, shape = (shape[axis],)
    axis: int

    @property
    def shape(self):
        return self.q.shape

    def _bcast(self, t):
        return t.reshape([-1 if i == self.axis else 1
                          for i in range(self.q.ndim)])

    def dequantize(self, dtype=torch.float32):
        return (self.q.float() * self._bcast(self.scale)).to(dtype)


def quantize(x: torch.Tensor, axis: int = -1) -> QTensor:
    """Symmetric per-channel int8: scale = absmax / 127."""
    axis = axis % x.ndim
    red = tuple(i for i in range(x.ndim) if i != axis)
    xf = x.float()
    absmax = xf.abs().amax(dim=red) if red else xf.abs()   # amax(dim=()) reduces all
    scale = torch.clamp_min(absmax / 127.0, SCALE_EPS)
    s = scale.reshape([-1 if i == axis else 1 for i in range(x.ndim)])
    q = torch.clamp(torch.round(xf / s), -127, 127)
    return QTensor(q.to(torch.int8), scale, axis)


def quantize_into(x: torch.Tensor, axis: int = -1):
    """Static-shape symmetric int8 quantization along one axis: the KV
    cache write path's quantizer, one scalar scale per reduced row.
    Returns raw ``(q, scale)``: ``q`` int8 with the shape of ``x``,
    ``scale`` fp32 with that shape less ``axis``."""
    axis = axis % x.ndim
    xf = x.float()
    absmax = xf.abs().amax(dim=axis, keepdim=True)
    scale = torch.clamp_min(absmax / 127.0, SCALE_EPS)
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale.squeeze(axis)


def dequantize_block(q: torch.Tensor, scale: torch.Tensor, axis: int = -1,
                     dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_into`: broadcast ``scale`` along
    ``axis`` and multiply."""
    axis = axis % q.ndim
    return (q.float() * scale.unsqueeze(axis)).to(dtype)


def quantization_error(x: torch.Tensor, qt: QTensor) -> float:
    """Relative L2 reconstruction error."""
    num = torch.linalg.vector_norm((x - qt.dequantize()).reshape(-1))
    den = torch.clamp_min(torch.linalg.vector_norm(x.reshape(-1)), 1e-12)
    return float(num / den)


def _is_quantizable(x) -> bool:
    return (isinstance(x, torch.Tensor) and x.ndim >= 2
            and x.is_floating_point())


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def quantize_tree(params, axis: int = -1):
    """int8-quantize every >=2D float leaf; smaller leaves pass through."""
    return _tree_map(
        lambda x: quantize(x, axis) if _is_quantizable(x) else x, params)


def dequantize_tree(params, dtype=torch.float32):
    return _tree_map(
        lambda x: x.dequantize(dtype) if isinstance(x, QTensor) else x,
        params)


def _leaf_bytes(x) -> int:
    if isinstance(x, QTensor):
        return (x.q.numel() * x.q.element_size()
                + x.scale.numel() * x.scale.element_size())
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, np.ndarray):
        return x.size * x.dtype.itemsize
    return 0                       # None / Python scalars carry no storage


def tree_bytes(params) -> int:
    """Total storage bytes of a tree, counting both the int8 payload and
    the scale arrays of every QTensor, each at its own itemsize."""
    return int(sum(_leaf_bytes(l) for l in _leaves(params)))


def compression_ratio(params) -> float:
    """fp32 bytes / quantized bytes for a quantized tree (the denominator
    includes the QTensor scale arrays)."""
    orig = int(sum(4 * l.q.numel() if isinstance(l, QTensor)
                   else _leaf_bytes(l) for l in _leaves(params)))
    return orig / max(tree_bytes(params), 1)
