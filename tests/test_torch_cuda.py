"""The CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device and skips without one.  The file
imports neither jax nor the repo's conftest, so it runs on a machine that
has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def randn(dev, *shape, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(*shape, generator=g).to(dev)


def close(got, want, rtol, atol):
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("act", ["none", "relu", "silu", "gelu"])
@pytest.mark.parametrize("m,k,n,transposed", [(37, 75, 19, False),
                                              (1024, 2400, 192, True),
                                              (8, 800, 500, False)])
def test_matmul_kernel(dev, m, k, n, transposed, act):
    a = randn(dev, m, k).relu()
    b = randn(dev, n, k, seed=1).t() if transposed else randn(dev, k, n, seed=1)
    b = b * (2 / k) ** 0.5
    bias = randn(dev, n, seed=2)
    close(kops.matmul(a, b, bias, activation=act),
          ref.matmul_ref(a, b, bias, activation=act), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("mode", ["max", "avg"])
@pytest.mark.parametrize("k,s,p", [(3, 2, 1), (8, 1, 0), (2, 2, 0), (3, 2, 0)])
def test_pool_kernel(dev, mode, k, s, p):
    x = randn(dev, 2, 5, 17, 16)
    close(kops.pool2d(x, mode=mode, kernel=k, stride=s, pad=p),
          ref.pool2d_ref(x, mode=mode, kernel=k, stride=s, pad=p),
          rtol=1e-6, atol=0)


@pytest.mark.parametrize("act", ["relu", "silu", "gelu", "tanh", "sigmoid"])
@pytest.mark.parametrize("offset", [0, 1])        # 1: unaligned, scalar path
def test_elementwise_kernel(dev, act, offset):
    x = (randn(dev, 4 * 1283 + offset) * 4)[offset:]
    close(kops.elementwise(x, act), ref.elementwise_ref(x, act),
          rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("r,n", [(8, 10), (64, 1000), (3, 33)])
def test_softmax_kernel(dev, r, n):
    x = randn(dev, r, n) * 5
    x[0, 0], x[-1, -1] = 1e4, -1e4
    close(kops.softmax(x), ref.softmax_ref(x), rtol=1e-5, atol=1e-8)


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    with pytest.raises(TypeError):
        kops.relu(torch.zeros(8, device=dev, dtype=torch.float64))
    with pytest.raises(ValueError):
        kops.softmax(torch.zeros(8, 4, device=dev).t())
    with pytest.raises(ValueError):
        kops.matmul(torch.zeros(4, 4, device=dev), torch.zeros(4, 4))


def test_nin_forward_launches_every_kernel(dev, tmp_path):
    from repro_torch.configs import get_config
    from repro_torch.core.engine import InferenceEngine
    from repro_torch.core.importer import to_caffe_json
    from repro_torch.core.modelstore import ModelStore
    from repro_torch.models import cnn
    g = cnn.graph_for(get_config("nin-cifar10"))
    params = g.init_params(torch.Generator().manual_seed(0))
    store = ModelStore(tmp_path)
    store.publish("nin", to_caffe_json(g, params)[0], params)
    engine = InferenceEngine(store)
    assert engine.backend == "cuda"
    x = np.random.default_rng(0).standard_normal((2, 3, 32, 32)) \
        .astype(np.float32)
    kops.reset_launches()
    y = engine.predict("nin", x)
    assert kops.launches() == {"matmul": 9, "elementwise": 9, "pool2d": 3,
                               "softmax": 1}
    y_ref = InferenceEngine(store, backend="ref").predict("nin", x)
    close(y, y_ref, rtol=0, atol=1e-5)
