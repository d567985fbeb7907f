"""End-to-end trainer.

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \
        --steps 200 --batch 8 --seq 128 --publish store/

The port of ``repro.launch.train``: AdamW steps of the next-token loss on
``SyntheticLM`` batches, then a publish into the model store, so the
serving path loads the result (the paper's train-once / reuse-everywhere
loop).  It runs on the CUDA card, where attention goes through the flash
kernels (B9 forward and backward); ``--device cpu`` runs it on the CPU
on the plain versions.  One card has no mesh: a batch is uploaded whole.
"""
from __future__ import annotations

import argparse
import math
import time

import torch

from repro_torch import models
from repro_torch.configs.base import get_config, reduced as reduce_cfg
from repro_torch.convert import params_from_numpy
from repro_torch.data.pipeline import DataConfig, SyntheticLM, to_device
from repro_torch.optim.adamw import AdamW, cosine_schedule, tree_items, tree_map
from repro_torch.runtime.base import resolve_device


def make_train_step(cfg, opt, *, backend=None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the loss and its gradients (attention on the flash
    ``backend``, None resolving by device), then ``opt.update``, which
    writes params and state in place.  Metrics stay on the device."""
    mod = models.get_module(cfg)

    def train_step(params, opt_state, batch):
        loss, metrics = mod.loss_fn(cfg, params, batch, backend=backend)
        leaves = [p for _, p in tree_items(params)]
        it = iter(torch.autograd.grad(loss, leaves))
        grads = tree_map(lambda p: next(it), params)
        params, opt_state, om = opt.update(grads, opt_state, params)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(om)
        return params, opt_state, metrics

    return train_step


def train(arch: str, *, steps: int = 100, batch: int = 8, seq: int = 128,
          lr: float = 3e-4, warmup: int = 20, use_reduced: bool = True,
          publish_to=None, log_every: int = 10, seed: int = 0,
          device="cuda", params=None, backend=None):
    """Train ``arch`` for ``steps`` steps; returns (params, losses).
    ``params``: a numpy tree to start from (default: drawn from
    ``torch.Generator(device)`` seeded with ``seed``); ``backend``: the
    flash attention backend (None: the kernels on the card)."""
    dev = resolve_device(device)
    cfg = get_config(arch)
    if use_reduced:
        cfg = reduce_cfg(cfg)
    if params is None:
        params = models.init_params(
            cfg, torch.Generator(dev).manual_seed(seed), device=dev)
    else:
        params = params_from_numpy(params, dev, cfg=cfg)
    params = tree_map(lambda p: p.requires_grad_(), params)
    n_params = sum(p.numel() for _, p in tree_items(params))
    opt = AdamW(lr=cosine_schedule(lr, warmup, steps))
    opt_state = opt.init(params)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                  global_batch=batch, seed=seed))
    step_fn = make_train_step(cfg, opt, backend=backend)

    print(f"training {cfg.name} ({n_params/1e6:.1f}M params) on {dev}, "
          f"{steps} steps batch={batch} seq={seq}")
    losses = []
    t0 = time.perf_counter()
    for step in range(steps):
        b = to_device(data.batch(step), dev)
        if cfg.family == "audio":
            # the stubbed audio frontend: zero frame embeddings
            b["frames"] = torch.zeros((batch, cfg.encoder_seq, cfg.d_model),
                                      dtype=torch.float32, device=dev)
        params, opt_state, metrics = step_fn(params, opt_state, b)
        loss = float(metrics["loss"])
        losses.append(loss)
        if step % log_every == 0 or step == steps - 1:
            dt = time.perf_counter() - t0
            tok_s = batch * seq * (step + 1) / dt
            print(f"step {step:5d}  loss {loss:7.4f}  {tok_s:9.0f} tok/s")
    if not math.isfinite(losses[-1]):
        raise RuntimeError(f"training diverged: loss {losses[-1]}")

    if publish_to:
        from repro_torch.checkpoint.ckpt import publish_checkpoint
        from repro_torch.core.modelstore import ModelStore
        store = ModelStore(publish_to)
        rec = publish_checkpoint(
            store, cfg.name, cfg, params,
            metadata={"steps": steps, "final_loss": losses[-1]})
        print(f"published {rec.name}:{rec.version} -> {rec.path}")
    return params, losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--full", action="store_true",
                    help="full config (default: reduced smoke variant)")
    ap.add_argument("--publish", default=None, metavar="STORE_DIR")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    _, losses = train(args.arch, steps=args.steps, batch=args.batch,
                      seq=args.seq, lr=args.lr, use_reduced=not args.full,
                      publish_to=args.publish, device=args.device)
    print(f"loss {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"(delta {losses[0] - losses[-1]:+.4f})")
    return losses


if __name__ == "__main__":
    main()
