"""Meta-model for on-device model selection: section 2's closing idea.

The port of ``repro.core.selector``.  "We have some ideas for a meta model
for selecting a model to use, which can use input like location, time of
day, and camera history to predict which models might be most relevant."

A small softmax regression over a hand-built context featurization
(cyclic time encoding, weekday and location one-hots, camera-history
class histogram), trained by full-batch gradient descent with
``torch.autograd``.  ``MultiModelServer(selector=...)`` asks it which
model serves a request context.  ``featurize`` builds the vector in
float64 numpy and casts it to float32 once, as the JAX package does, so
the two packages' features are bit-equal.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np
import torch


@dataclass
class ContextSpec:
    num_locations: int = 8
    history_classes: int = 10

    @property
    def dim(self) -> int:
        # sin/cos hour + weekday one-hot(7) + location + history histogram
        return 2 + 7 + self.num_locations + self.history_classes


def featurize(spec: ContextSpec, *, hour: float, weekday: int,
              location: int, history: Sequence[float]) -> torch.Tensor:
    """The context's (dim,) float32 feature vector, on the CPU."""
    ang = 2 * np.pi * hour / 24.0
    f = [np.sin(ang), np.cos(ang)]
    wd = np.zeros(7)
    wd[weekday % 7] = 1.0
    loc = np.zeros(spec.num_locations)
    loc[location % spec.num_locations] = 1.0
    hist = np.asarray(history, np.float32)
    if hist.shape != (spec.history_classes,):
        raise ValueError(f"featurize: history of shape {hist.shape}, "
                         f"expected ({spec.history_classes},)")
    hist = hist / max(hist.sum(), 1e-9)
    return torch.from_numpy(
        np.concatenate([f, wd, loc, hist]).astype(np.float32))


class MetaSelector:
    """Softmax regression: context features -> distribution over models.

    The weights live on ``device``; the initial ``w`` is 0.01 times a
    normal draw from ``generator`` (the draws differ from the JAX
    package's ``jax.random``), ``b`` starts at zero."""

    def __init__(self, spec: ContextSpec, model_names: List[str], *,
                 generator: torch.Generator, device="cuda"):
        self.spec = spec
        self.model_names = list(model_names)
        self.device = torch.device(device)
        w = torch.randn((spec.dim, len(self.model_names)),
                        generator=generator, device=generator.device)
        self.w = (0.01 * w).to(self.device)
        self.b = torch.zeros(len(self.model_names), device=self.device)

    def logits(self, feats) -> torch.Tensor:
        return feats.to(self.device) @ self.w + self.b

    def rank(self, feats) -> List[str]:
        order = np.argsort(-self.logits(feats).cpu().numpy())
        return [self.model_names[i] for i in order]

    def select(self, feats, k: int = 1) -> List[str]:
        return self.rank(feats)[:k]

    def fit(self, feats, labels, *, steps: int = 300,
            lr: float = 0.5) -> float:
        """Full-batch gradient descent on the softmax cross entropy of
        ``feats`` (M, dim) against ``labels`` (M,); returns the loss of
        the last step (before its update), as the JAX package does."""
        feats = feats.to(self.device, torch.float32)
        labels = labels.to(self.device, torch.long)
        w = self.w.clone().requires_grad_()
        b = self.b.clone().requires_grad_()
        for _ in range(steps):
            lp = torch.log_softmax(feats @ w + b, dim=-1)
            loss = -lp.gather(1, labels[:, None]).mean()
            gw, gb = torch.autograd.grad(loss, (w, b))
            with torch.no_grad():
                w -= lr * gw
                b -= lr * gb
        self.w, self.b = w.detach(), b.detach()
        return float(loss.detach())

    def accuracy(self, feats, labels) -> float:
        pred = self.logits(feats).argmax(-1)
        return float((pred == labels.to(self.device)).float().mean())
