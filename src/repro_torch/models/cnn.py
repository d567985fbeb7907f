"""CNN family (NIN / LeNet) — the paper's own models, via the core graph.

The port of ``repro.models.cnn``: a layer-graph spec (the Caffe->JSON
interchange) executed by ``repro_torch.core.graph``.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.graph import Graph


def graph_for(cfg: ArchConfig) -> Graph:
    if cfg.name == "nin-cifar10":
        from repro_torch.configs.nin_cifar10 import NIN_CIFAR10_SPEC as spec
    elif cfg.name == "lenet-mnist":
        from repro_torch.configs.lenet_mnist import LENET_MNIST_SPEC as spec
    else:
        raise KeyError(cfg.name)
    return Graph.from_spec(spec)


def init_params(cfg: ArchConfig, generator: torch.Generator):
    return graph_for(cfg).init_params(generator)


def forward(cfg: ArchConfig, params, images, **kw):
    return graph_for(cfg).apply(params, images, **kw)
