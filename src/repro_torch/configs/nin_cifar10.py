"""Network-in-Network on CIFAR-10 — the paper's own flagship model.

[arXiv:1312.4400] Lin, Chen, Yan, "Network In Network".  The exact model
DeepLearningKit section 1.1 benchmarks on iPhone 5S/6S: ~20 ops deep
(3 NIN blocks of conv + 2x mlpconv 1x1, pooling between, softmax head).
Described as a layer-graph JSON spec consumed by repro_torch.core.importer —
the same path the paper's Caffe->JSON converter feeds.
"""
from repro_torch.configs.base import ArchConfig, register

# conv cfg: (out_ch, kernel, stride, pad)
NIN_CIFAR10_SPEC = {
    "name": "nin-cifar10",
    "input": [3, 32, 32],
    "num_classes": 10,
    "blocks": [
        # block 1
        {"conv": (192, 5, 1, 2)}, {"relu": True},
        {"conv": (160, 1, 1, 0)}, {"relu": True},
        {"conv": (96, 1, 1, 0)}, {"relu": True},
        {"pool": ("max", 3, 2, 1)},
        # block 2
        {"conv": (192, 5, 1, 2)}, {"relu": True},
        {"conv": (192, 1, 1, 0)}, {"relu": True},
        {"conv": (192, 1, 1, 0)}, {"relu": True},
        {"pool": ("avg", 3, 2, 1)},
        # block 3
        {"conv": (192, 3, 1, 1)}, {"relu": True},
        {"conv": (192, 1, 1, 0)}, {"relu": True},
        {"conv": (10, 1, 1, 0)}, {"relu": True},
        {"pool": ("avg", 8, 1, 0)},  # global average pooling
        {"softmax": True},
    ],
}


@register("nin-cifar10")
def config() -> ArchConfig:
    # CNN models reuse ArchConfig loosely; the real spec is NIN_CIFAR10_SPEC.
    return ArchConfig(
        name="nin-cifar10",
        family="cnn",
        num_layers=20,
        d_model=192,
        num_heads=1,
        num_kv_heads=1,
        d_ff=0,
        vocab_size=10,
        dtype="float32",
        source="arXiv:1312.4400 (NIN, CIFAR-10) via DeepLearningKit sec 1",
    )
