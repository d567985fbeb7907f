"""Train -> publish -> serve on the PyTorch/CUDA port: closing the paper's
asymmetry loop, as ``train_publish_serve.py`` closes it on the JAX package.

Section 2's thesis: training is expensive and happens once; the artifact
is then reused many times from a model store.  This example trains a
small transformer on the synthetic Zipf-Markov corpus until the loss
visibly drops, publishes the checkpoint into the store, reloads it
through the serving engine, and generates.

    PYTHONPATH=src python examples/train_publish_serve_torch.py [--steps 150]               # the CUDA card
    PYTHONPATH=src python examples/train_publish_serve_torch.py --device cpu [--steps 150]  # the CPU

It runs on the card (the hand-written kernels) and raises without one,
unless ``--device cpu`` is given.  Imports torch and ``repro_torch`` only.
"""
import argparse
import tempfile

import numpy as np

from repro_torch.checkpoint.ckpt import load_published
from repro_torch.core.modelstore import ModelStore
from repro_torch.launch.train import train
from repro_torch.runtime.base import resolve_device
from repro_torch.serving.engine import Request, ServingEngine

MIN_DROP = 0.3


def train_and_publish(device, root, *, arch="qwen3-0.6b", steps=150,
                      init_root=None):
    """Train the reduced ``arch`` for ``steps`` steps (batch 8 x 128) and
    publish it into the store at ``root``; returns the per-step losses.
    ``init_root``: a store holding ``arch``'s starting weights (published
    by either package); default: drawn from a seeded ``torch.Generator``."""
    params = None
    if init_root is not None:
        params = load_published(ModelStore(init_root), arch)[1]
        params = _to_numpy(params)
    _, losses = train(arch, steps=steps, batch=8, seq=128, publish_to=root,
                      log_every=25, device=device, params=params)
    return losses


def reload_and_serve(device, root, *, arch="qwen3-0.6b"):
    """Reload ``arch`` from the store at ``root`` and generate greedily
    for three prompts; returns the requests."""
    store = ModelStore(root)
    cfg, params, rec = load_published(store, arch)
    print(f"reloaded {rec.name}:{rec.version} from the store")

    eng = ServingEngine(cfg, params, max_batch=4, cache_len=128,
                        device=device)
    rng = np.random.default_rng(0)
    reqs = [Request(uid=i, prompt=[int(t) for t in rng.integers(
                1, cfg.vocab_size, 10)], max_new_tokens=12)
            for i in range(3)]
    stats = eng.generate_batch(reqs)
    for r in reqs:
        print(f"req {r.uid}: {r.prompt[:6]}... -> {r.output}")
    print(f"{stats.tokens_out} tokens at {stats.tok_per_s:.1f} tok/s")
    return reqs


def run(device="cuda", *, steps=150, arch="qwen3-0.6b"):
    """Train, check that the loss dropped by more than ``MIN_DROP``,
    publish, reload and serve; returns (losses, requests)."""
    dev = resolve_device(device)
    with tempfile.TemporaryDirectory() as root:
        losses = train_and_publish(dev, root, arch=arch, steps=steps)
        drop = losses[0] - losses[-1]
        print(f"\nloss {losses[0]:.3f} -> {losses[-1]:.3f} "
              f"(drop {drop:.3f}; must be > {MIN_DROP})")
        if not drop > MIN_DROP:
            raise AssertionError("training did not learn")
        return losses, reload_and_serve(dev, root, arch=arch)


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    return run(args.device, steps=args.steps, arch=args.arch)


if __name__ == "__main__":
    main()
