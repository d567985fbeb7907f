"""End-to-end serving driver on the PyTorch/CUDA port (the paper's kind:
on-device inference), as ``serve_batched.py`` drives the JAX package.

A store with several pre-trained models, a meta-selector routing request
contexts to models, LRU-resident weights, batched prefill + decode with
KV caches, and hot model switching — paper section 2 end to end.

    PYTHONPATH=src python examples/serve_batched_torch.py               # the CUDA card
    PYTHONPATH=src python examples/serve_batched_torch.py --device cpu  # the CPU

It runs on the card (the hand-written kernels) and raises without one,
unless ``--device cpu`` is given.  Imports torch and ``repro_torch`` only.
"""
import argparse
import tempfile
import time

import numpy as np
import torch

from repro_torch import models
from repro_torch.checkpoint.ckpt import publish_checkpoint
from repro_torch.configs.base import get_config, reduced
from repro_torch.core.modelstore import ModelStore
from repro_torch.core.selector import ContextSpec, MetaSelector, featurize
from repro_torch.runtime.base import resolve_device
from repro_torch.serving.engine import MultiModelServer, Request

MODELS = ["tinyllama-1.1b", "qwen3-0.6b", "rwkv6-3b"]


def run(device="cuda", store_root=None, rounds: int = 6, requests: int = 3):
    """Serve ``rounds`` rounds of ``requests`` requests on ``device``;
    returns one (location, model picked, the requests' tokens) a round.

    ``store_root``: a store that already holds the three reduced models
    (published by either package); default: a temporary store with
    models drawn from ``torch.Generator`` seeds 0, 1, 2."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory() as tmp:
        store = ModelStore(store_root or tmp)
        if store_root is None:
            for i, arch in enumerate(MODELS):
                cfg = reduced(get_config(arch))
                params = models.init_params(cfg,
                                            torch.Generator().manual_seed(i))
                rec = publish_checkpoint(store, arch, cfg, params)
                print(f"published {rec.name}:{rec.version}")

        # train the meta-selector: location i prefers model i (sec 2's
        # "use input like location, time of day ... to predict which
        # models might be most relevant")
        spec = ContextSpec(num_locations=4, history_classes=4)
        feats, labels = [], []
        for n in range(300):
            loc = n % len(MODELS)
            feats.append(featurize(spec, hour=n % 24, weekday=n % 7,
                                   location=loc, history=np.eye(4)[n % 4]))
            labels.append(loc)
        feats, labels = torch.stack(feats), torch.tensor(labels)
        sel = MetaSelector(spec, MODELS,
                           generator=torch.Generator().manual_seed(0),
                           device=dev)
        sel.fit(feats, labels)
        print(f"meta-selector trained: acc={sel.accuracy(feats, labels):.2f}")

        server = MultiModelServer(store, max_resident=3, selector=sel,
                                  max_batch=4, cache_len=96, device=dev)
        uid, served = 0, []
        for round_i in range(rounds):
            loc = round_i % len(MODELS)
            ctx = featurize(spec, hour=9 + round_i, weekday=2, location=loc,
                            history=np.eye(4)[0])
            reqs = [Request(uid=uid + j,
                            prompt=[int(t) for t in rng.integers(1, 250, 12)],
                            max_new_tokens=8) for j in range(requests)]
            uid += requests
            t0 = time.perf_counter()
            stats = server.serve(reqs, context_feats=ctx)
            model, switch_s = server.switch_log[-1]
            print(f"[req ctx loc={loc}] -> {model:16s} "
                  f"{stats.tokens_out} toks  {stats.tok_per_s:7.1f} tok/s  "
                  f"switch {switch_s*1e3:6.1f}ms  "
                  f"total {(time.perf_counter()-t0)*1e3:6.0f}ms")
            served.append((loc, model, [list(r.output) for r in reqs]))
        print(f"resident cache: hits={server.cache.hits} "
              f"misses={server.cache.misses} resident={server.cache.resident}")
    return served


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--requests", type=int, default=3,
                    help="requests a round")
    args = ap.parse_args(argv)
    return run(args.device, rounds=args.rounds, requests=args.requests)


if __name__ == "__main__":
    main()
