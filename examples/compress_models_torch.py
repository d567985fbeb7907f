"""Compression pipeline walk-through on the PyTorch/CUDA port (paper sec
2 + roadmap 7/8), as ``compress_models.py`` walks it on the JAX package.

Quantizes and compresses the paper's NIN model, verifies the classifier
still agrees with fp32, and prints the bytes story behind "eighteen
thousand AlexNet models on a 128 GB iPhone".

    PYTHONPATH=src python examples/compress_models_torch.py               # the CUDA card
    PYTHONPATH=src python examples/compress_models_torch.py --device cpu  # the CPU

It runs on the card (the hand-written kernels) and raises without one,
unless ``--device cpu`` is given.  Imports torch and ``repro_torch`` only.
"""
import argparse

import torch

from repro_torch.configs.base import get_config
from repro_torch.core import compress, quantize
from repro_torch.models import cnn
from repro_torch.runtime.base import resolve_device


def run(device="cuda", params=None, x=None):
    """The walk-through on ``device``; returns {"ratio", "agree",
    "max_dprob", "layer", "report"} (``report``: ``compress_report`` of
    the largest conv weight).

    ``params``: a numpy weight tree to start from, default drawn from a
    ``torch.Generator`` seeded with 0; ``x``: (32, 3, 32, 32) numpy
    images, default normal draws seeded with 1."""
    dev = resolve_device(device)
    cfg = get_config("nin-cifar10")
    g = cnn.graph_for(cfg)
    if params is None:
        params = g.init_params(torch.Generator().manual_seed(0))
    params = {l: {k: torch.as_tensor(v).to(dev) for k, v in leaves.items()}
              for l, leaves in params.items()}
    if x is None:
        x = torch.randn((32, 3, 32, 32),
                        generator=torch.Generator().manual_seed(1))
    x = torch.as_tensor(x).to(dev)
    # the hand-written kernels on the card, as InferenceEngine picks them
    backend = "cuda" if dev.type == "cuda" else "ref"
    y_fp = g.apply(params, x, backend=backend)

    # int8 everything >=2D, keep biases fp32
    qt = quantize.quantize_tree(params)
    ratio = quantize.tree_bytes(params) / quantize.tree_bytes(qt)
    y_q = g.apply(quantize.dequantize_tree(qt), x, backend=backend)
    agree = float((torch.argmax(y_q, -1) == torch.argmax(y_fp, -1))
                  .float().mean())
    max_dprob = float((y_q - y_fp).abs().max())
    print(f"int8: {ratio:.2f}x smaller, top-1 agreement {agree:.1%}, "
          f"max |dprob| {max_dprob:.4f}")

    # per-stage report on the biggest conv weight
    big = max(
        ((k, v) for k, lv in params.items() for v in [lv.get("w")]
         if v is not None and v.ndim >= 2),
        key=lambda kv: kv[1].numel())
    w2d = big[1].reshape(big[1].shape[0], -1)
    rep = compress.compress_report(w2d, rank=min(64, min(w2d.shape) // 2),
                                   sparsity=0.9)
    print(f"\nstage report on {big[0]} {tuple(big[1].shape)}:")
    for k in ("int8", "pruned", "lowrank", "lowrank+int8"):
        r = rep[k]
        print(f"  {k:14s} {r['ratio']:5.1f}x  err={r['error']:.3f}")

    per_alexnet = 240e6 / (240 / 6.9)
    print(f"\npaper arithmetic: 128 GB / 6.9 MB = "
          f"{int(128e9 / per_alexnet):,} AlexNets on one phone")
    return {"ratio": ratio, "agree": agree, "max_dprob": max_dprob,
            "layer": big[0], "report": rep}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    return run(args.device)


if __name__ == "__main__":
    main()
