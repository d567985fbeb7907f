"""Synthetic tokenized data: deterministic, restartable, numpy only.

A copy of ``repro.data.pipeline`` (which imports jax for its mesh
placement): the same Zipf-Markov generator, so a batch is bit-equal to the
reference's for the same (seed, step).  :func:`to_device` puts a batch
on one card; :func:`shard_batch` splits it over a mesh's data axes as
DTensors.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np
import torch


@dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2           # unigram skew
    markov_weight: float = 0.7    # how much t+1 depends on t


class SyntheticLM:
    """Zipf-Markov synthetic corpus. Deterministic given (seed, step)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        # Zipfian unigram distribution
        ranks = np.arange(1, v + 1, dtype=np.float64)
        self.unigram = (ranks ** -cfg.zipf_a)
        self.unigram /= self.unigram.sum()
        # sparse deterministic successor table: tok -> preferred next
        self.successor = rng.integers(0, v, size=v)

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        b, s = cfg.global_batch, cfg.seq_len
        base = rng.choice(cfg.vocab_size, size=(b, s), p=self.unigram)
        toks = base.copy()
        follow = rng.random((b, s)) < cfg.markov_weight
        toks[:, 1:] = np.where(follow[:, 1:],
                               self.successor[toks[:, :-1]], base[:, 1:])
        return {"tokens": toks.astype(np.int32),
                "labels": toks.astype(np.int32)}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


class ByteTokenizer:
    """Trivial byte-level tokenizer (vocab 256 + bos/eos)."""
    BOS, EOS = 256, 257
    vocab_size = 258

    def encode(self, text: str, add_special: bool = True):
        ids = list(text.encode("utf-8"))
        return [self.BOS] + ids + [self.EOS] if add_special else ids

    def decode(self, ids):
        return bytes(i for i in ids if i < 256).decode("utf-8",
                                                       errors="replace")


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A host batch on ``device``, as int64 token ids; to a CUDA device
    through pinned memory and a non-blocking copy, as the scheduler
    uploads."""
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v)).long()
        out[k] = t.pin_memory().to(device, non_blocking=True) \
            if device.type == "cuda" else t
    return out


def shard_batch(batch, mesh, batch_axes=("pod", "data")):
    """A host batch (the same on every rank) as DTensors on ``mesh``,
    token ids as int64, split along the batch dim over those of
    ``batch_axes`` the mesh has."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.sharding_hints import to_placements
    axes = tuple(a for a in batch_axes if a in mesh.mesh_dim_names)
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(np.ascontiguousarray(v)) \
            if isinstance(v, np.ndarray) else v
        if not t.is_floating_point():
            t = t.long()
        spec = (axes,) + (None,) * (t.ndim - 1)
        out[k] = distribute_tensor(t, mesh, list(to_placements(spec, mesh)))
    return out
