"""LeNet on MNIST — the paper's second supported model (Theano-trained).

[LeCun et al. 1998 / DeepLearningKit sec 1] conv(20,5)-pool-conv(50,5)-
pool-fc(500)-relu-fc(10)-softmax.
"""
from repro_torch.configs.base import ArchConfig, register

LENET_MNIST_SPEC = {
    "name": "lenet-mnist",
    "input": [1, 28, 28],
    "num_classes": 10,
    "blocks": [
        {"conv": (20, 5, 1, 0)},
        {"pool": ("max", 2, 2, 0)},
        {"conv": (50, 5, 1, 0)},
        {"pool": ("max", 2, 2, 0)},
        {"flatten": True},
        {"dense": 500}, {"relu": True},
        {"dense": 10},
        {"softmax": True},
    ],
}


@register("lenet-mnist")
def config() -> ArchConfig:
    return ArchConfig(
        name="lenet-mnist",
        family="cnn",
        num_layers=8,
        d_model=50,
        num_heads=1,
        num_kv_heads=1,
        d_ff=500,
        vocab_size=10,
        dtype="float32",
        source="LeCun 1998 LeNet-5 via DeepLearningKit sec 1 (Theano LeNet)",
    )
