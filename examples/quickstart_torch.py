"""Quickstart on the PyTorch/CUDA port: the paper's flagship path in five
steps, as ``quickstart.py`` walks it on the JAX package.

  1. Build NIN/CIFAR-10 (the exact network of paper sec 1.1).
  2. Export it to the Caffe-style JSON interchange (paper sec 3).
  3. Publish it to the model App Store (paper sec 2), int8-compressed.
  4. Load it through the inference engine (Metal-pipeline analogue).
  5. Classify a batch of images, with command-buffer semantics.

    PYTHONPATH=src python examples/quickstart_torch.py               # the CUDA card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu  # the CPU

It runs on the card (the hand-written kernels) and raises without one,
unless ``--device cpu`` is given.  Imports torch and ``repro_torch`` only.
"""
import argparse
import tempfile

import torch

from repro_torch.configs.base import get_config
from repro_torch.core.engine import InferenceEngine
from repro_torch.core.importer import to_caffe_json
from repro_torch.core.modelstore import ModelStore
from repro_torch.models import cnn
from repro_torch.runtime.base import resolve_device


def run(device="cuda", params=None, images=None):
    """The five steps on ``device``; returns the predicted class ids.

    ``params``: a numpy weight tree ({layer: {leaf: array}}, as a store's
    ``weights.npz`` holds it) to start from, default drawn from a
    ``torch.Generator`` seeded with 0; ``images``: (8, 3, 32, 32) numpy,
    default normal draws seeded with 1."""
    dev = resolve_device(device)
    # 1. the network (20-op NIN, conv/relu/pool/softmax shaders)
    cfg = get_config("nin-cifar10")
    graph = cnn.graph_for(cfg)
    if params is None:
        params = graph.init_params(torch.Generator().manual_seed(0))
    else:
        params = {l: {k: torch.as_tensor(v) for k, v in leaves.items()}
                  for l, leaves in params.items()}
    print(f"built {cfg.name}: {len(graph.layers)} layers, "
          f"{graph.flops(1)/1e9:.2f} GFLOPs/image")

    # 2. JSON interchange (what the paper's Caffe converter produces)
    doc, _ = to_caffe_json(graph, params)
    print(f"exported {len(doc['layers'])} layers to JSON "
          f"({[l['type'] for l in doc['layers'][:4]]} ...)")

    with tempfile.TemporaryDirectory() as root:
        # 3. publish to the app store, int8-compressed
        store = ModelStore(root)
        rec = store.publish("nin-cifar10", doc, params, int8=True,
                            tags=["cifar10", "quickstart"])
        print(f"published {rec.name}:{rec.version} "
              f"({rec.manifest['weights_bytes']/1e6:.2f} MB int8)")

        # 4. engine: store -> device-resident pipeline state
        engine = InferenceEngine(store, device=dev)

        # 5. classify (enqueue = commit, fence = waitUntilCompleted)
        if images is None:
            images = torch.randn((8, 3, 32, 32),
                                 generator=torch.Generator().manual_seed(1))
        cb = engine.enqueue("nin-cifar10", torch.as_tensor(images))
        probs = cb.wait_until_completed()
        preds = torch.argmax(probs, dim=-1).tolist()
        print(f"predictions: {preds}")
        print(f"engine stats: {engine.stats}")
    return preds


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    return run(args.device)


if __name__ == "__main__":
    main()
