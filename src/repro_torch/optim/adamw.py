"""AdamW and a cosine schedule for the port's parameter dicts.

The port of ``repro.optim.adamw``.  State mirrors the params (m, v in
fp32) plus a 0-dim int32 step on the params' device.  The arithmetic is
the reference's, term for term: global-norm clipping, bias corrections
``1 - b ** step``, weight decay added to the Adam direction.  Where the
JAX version builds new trees, ``update`` writes params, m and v in place
under ``torch.no_grad()`` (at full width each tree is GBs) and returns
the same objects.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch


class AdamWState(NamedTuple):
    step: torch.Tensor       # 0-dim int32
    m: Any                   # tree like params, fp32
    v: Any


def tree_items(tree, prefix=()):
    """(path, leaf) pairs in sorted-key order, the order of
    ``jax.tree.leaves`` over dicts."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_items(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def tree_map(fn, *trees):
    """``fn`` over the leaves of dicts of one structure, in the order of
    :func:`tree_items`."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees))
                for k in sorted(trees[0])}
    return fn(*trees)


@dataclass(frozen=True)
class AdamW:
    lr: Callable[[torch.Tensor], torch.Tensor] | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0

    def init(self, params) -> AdamWState:
        leaf = next(iter(tree_items(params)))[1]
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
        return AdamWState(
            torch.zeros((), dtype=torch.int32, device=leaf.device),
            tree_map(zeros, params), tree_map(zeros, params))

    def _lr(self, step):
        return self.lr(step) if callable(self.lr) else self.lr

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params
               ) -> Tuple[Any, AdamWState, Dict[str, torch.Tensor]]:
        step = state.step + 1
        # global-norm clip
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                               for _, g in tree_items(grads)))
        scale = torch.clamp_max(self.grad_clip / (gnorm + 1e-9), 1.0) \
            if self.grad_clip else 1.0
        bc1 = 1 - self.b1 ** step.float()
        bc2 = 1 - self.b2 ** step.float()
        lr = self._lr(step)

        def upd(p, g, m_, v_):
            g = g.float() * scale
            m_.copy_(self.b1 * m_ + (1 - self.b1) * g)
            v_.copy_(self.b2 * v_ + (1 - self.b2) * g * g)
            mh = m_ / bc1
            vh = v_ / bc2
            delta = mh / (torch.sqrt(vh) + self.eps)
            if self.weight_decay:
                delta = delta + self.weight_decay * p.float()
            p.copy_((p.float() - lr * delta).to(p.dtype))

        tree_map(upd, params, grads, state.m, state.v)
        lr_t = torch.as_tensor(lr, dtype=torch.float32, device=gnorm.device)
        return params, AdamWState(step, state.m, state.v), \
            {"grad_norm": gnorm, "lr": lr_t}


def cosine_schedule(peak: float, warmup: int, total: int,
                    floor: float = 0.1):
    """Linear warmup to ``peak``, then a cosine down to ``floor * peak``
    at ``total``; ``fn(step)`` takes an integer tensor."""
    def fn(step):
        step = torch.as_tensor(step).float()
        warm = peak * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak * (floor + (1 - floor) * 0.5 *
                      (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup, warm, cos)
    return fn
