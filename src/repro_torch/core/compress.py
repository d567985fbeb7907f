"""Model compression — roadmap items 7 (compressed models) and 8
(approximate matrix multiplication).

The port of ``repro.core.compress``.  Three composable stages, mirroring
the Deep-Compression pipeline the paper cites ("AlexNet 240MB -> 6.9MB"):

  1. ``lowrank`` — truncated-SVD factorization W ~= U V (the matmul x@W
     becomes the cheaper (x@U)@V).
  2. ``prune``   — magnitude pruning to a target sparsity, stored as
     (values, int32 indices) pairs.
  3. int8 quantization — see :mod:`repro_torch.core.quantize`.

``compress_report`` measures bytes and reconstruction error per stage,
with the JAX package's byte accounting.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core.quantize import quantize


@dataclass
class LowRank:
    u: torch.Tensor      # (m, r)
    v: torch.Tensor      # (r, n)

    @property
    def shape(self):
        return (self.u.shape[0], self.v.shape[1])

    def dense(self):
        return self.u @ self.v

    def matmul(self, x):
        """Approximate x @ W: two thin matmuls, 2r(m+n)/(mn) of the FLOPs."""
        return (x @ self.u) @ self.v


def lowrank(w: torch.Tensor, rank: Optional[int] = None,
            energy: float = 0.95) -> LowRank:
    """Truncated SVD of a 2D matrix; the rank is the smallest whose
    singular values hold ``energy`` of the squared sum, if not given."""
    if w.ndim != 2:
        raise ValueError(f"lowrank: a 2D matrix, got shape {tuple(w.shape)}")
    u, s, vt = torch.linalg.svd(w.float(), full_matrices=False)
    if rank is None:
        cum = torch.cumsum(s ** 2, 0) / torch.sum(s ** 2)
        # jnp.searchsorted's default side='left': the first index with
        # cum >= energy
        rank = int(torch.searchsorted(cum, torch.tensor(
            energy, dtype=cum.dtype, device=cum.device))) + 1
    rank = max(1, min(rank, s.shape[0]))
    root = torch.sqrt(s[:rank])
    return LowRank(u[:, :rank] * root[None, :], root[:, None] * vt[:rank])


@dataclass
class Sparse:
    """Flat COO storage of a magnitude-pruned tensor."""
    values: torch.Tensor     # (nnz,)
    indices: torch.Tensor    # (nnz,) int32 flat indices
    shape: Tuple[int, ...]

    def dense(self):
        out = torch.zeros(int(torch.Size(self.shape).numel()),
                          dtype=self.values.dtype, device=self.values.device)
        out[self.indices.long()] = self.values
        return out.reshape(self.shape)


def prune(w: torch.Tensor, sparsity: float = 0.9) -> Sparse:
    """Keep the top-(1 - sparsity) fraction of weights by magnitude (the
    count rounded half to even, as Python's ``round``)."""
    flat = w.reshape(-1)
    keep = max(1, int(round(flat.shape[0] * (1.0 - sparsity))))
    _, idx = torch.topk(flat.abs(), keep)
    idx = torch.sort(idx).values
    return Sparse(flat[idx], idx.to(torch.int32), tuple(w.shape))


def rel_error(w, w_hat) -> float:
    n = torch.linalg.vector_norm((w - w_hat).reshape(-1))
    d = torch.clamp_min(torch.linalg.vector_norm(w.reshape(-1)), 1e-12)
    return float(n / d)


def compress_report(w: torch.Tensor, *, rank: Optional[int] = None,
                    sparsity: float = 0.9) -> Dict[str, Any]:
    """Bytes and error for each stage of the pipeline on one matrix."""
    base_bytes = w.numel() * 4
    lr = lowrank(w, rank=rank)
    lr_bytes = (lr.u.numel() + lr.v.numel()) * 4
    sp = prune(w, sparsity)
    sp_bytes = sp.values.numel() * 4 + sp.indices.numel() * 4
    qt = quantize(w)
    qt_bytes = qt.q.numel() + qt.scale.numel() * 4
    # composed: the low-rank factors, quantized
    uq, vq = quantize(lr.u), quantize(lr.v)
    comp_bytes = uq.q.numel() + vq.q.numel() + \
        (uq.scale.numel() + vq.scale.numel()) * 4
    return {
        "fp32_bytes": base_bytes,
        "lowrank": {"bytes": lr_bytes, "rank": lr.u.shape[1],
                    "ratio": base_bytes / lr_bytes,
                    "error": rel_error(w, lr.dense())},
        "pruned": {"bytes": sp_bytes, "ratio": base_bytes / sp_bytes,
                   "error": rel_error(w, sp.dense())},
        "int8": {"bytes": qt_bytes, "ratio": base_bytes / qt_bytes,
                 "error": rel_error(w, qt.dequantize())},
        "lowrank+int8": {"bytes": comp_bytes,
                         "ratio": base_bytes / comp_bytes,
                         "error": rel_error(
                             w, uq.dequantize() @ vq.dequantize())},
    }
