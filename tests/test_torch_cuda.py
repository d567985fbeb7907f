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
    counts = {k: n for k, n in kops.launches().items() if n}
    assert counts == {"matmul": 9, "conv2d": 9, "elementwise": 9,
                      "pool2d": 3, "softmax": 1}
    y_ref = InferenceEngine(store, backend="ref").predict("nin", x)
    close(y, y_ref, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# B6 / B7: flash-decode against its plain version.  Both sides compute in
# fp32 from the same stored values, so one tolerance holds for all three
# cache dtypes: rtol 1e-4, atol 1e-5 (summation order only).
# ---------------------------------------------------------------------------

DECODE_TOL = dict(rtol=1e-4, atol=1e-5)


def _cache(dev, shape, dtype, seed):
    if dtype == torch.int8:
        g = torch.Generator().manual_seed(seed)
        return torch.randint(-127, 128, shape, generator=g,
                             dtype=torch.int8).to(dev)
    return randn(dev, *shape, seed=seed).to(dtype)


def _scales(dev, shape, seed):
    g = torch.Generator().manual_seed(seed)
    return (0.01 + 0.04 * torch.rand(*shape, generator=g)).to(dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("layout", ["bksd", "bskd"])
@pytest.mark.parametrize("b,kvh,g", [(1, 4, 8), (8, 4, 8), (8, 8, 2)])
def test_decode_attention_ring_kernel(dev, dtype, layout, b, kvh, g):
    s, d = 1024, 64
    shape = (b, kvh, s, d) if layout == "bksd" else (b, s, kvh, d)
    q = randn(dev, b, kvh * g, d)
    k, v = _cache(dev, shape, dtype, 1), _cache(dev, shape, dtype, 2)
    valid = torch.tensor(([1, s, 65, 700, 64, 129, 1000, 2] * 2)[:b],
                         dtype=torch.int32, device=dev)
    if dtype == torch.int8:
        ks, vs = _scales(dev, shape[:3], 3), _scales(dev, shape[:3], 4)
        got = kops.decode_attention_q8(q, k, v, ks, vs, valid, layout=layout)
        want = ref.decode_attention_q8_ref(q, k, v, ks, vs, valid,
                                           layout=layout)
    else:
        got = kops.decode_attention(q, k, v, valid, layout=layout)
        want = ref.decode_attention_ref(q, k, v, valid, layout=layout)
    close(got, want, **DECODE_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.int8])
@pytest.mark.parametrize("layout", ["bksd", "bskd"])
def test_decode_attention_paged_kernel_fragmented(dev, dtype, layout):
    """Shuffled pages, the garbage page 0 in unused entries, and one pool
    page shared by two lanes."""
    b, kvh, g, d, ps, w = 8, 4, 8, 64, 16, 64
    p = 1 + b * w
    rng = np.random.default_rng(0)
    shape = (p, kvh, ps, d) if layout == "bksd" else (p, ps, kvh, d)
    q = randn(dev, b, kvh * g, d)
    k, v = _cache(dev, shape, dtype, 1), _cache(dev, shape, dtype, 2)
    valid = np.array([1, 1024, 17, 300, 16, 33, 999, 512])
    pt = rng.permutation(np.arange(1, p)).reshape(b, w).astype(np.int32)
    for i, n in enumerate(valid):
        pt[i, -(-n // ps):] = 0                      # unused -> garbage page
    pt[3, 0] = pt[2, 0]                              # a shared page
    pt = torch.from_numpy(pt).to(dev)
    vl = torch.from_numpy(valid.astype(np.int32)).to(dev)
    if dtype == torch.int8:
        ks, vs = _scales(dev, shape[:3], 3), _scales(dev, shape[:3], 4)
        got = kops.decode_attention_paged_q8(q, k, v, ks, vs, pt, vl,
                                             layout=layout)
        want = ref.decode_attention_paged_q8_ref(q, k, v, ks, vs, pt, vl,
                                                 layout=layout)
    else:
        got = kops.decode_attention_paged(q, k, v, pt, vl, layout=layout)
        want = ref.decode_attention_paged_ref(q, k, v, pt, vl, layout=layout)
    close(got, want, **DECODE_TOL)


def test_decode_attention_reads_nothing_past_valid_len(dev):
    """NaN in every slot past a lane's prefix leaves the output finite and
    unchanged; the layer view of an (L, B, KV, S, D) cache needs no copy."""
    b, kvh, g, s, d = 4, 4, 8, 1024, 64
    k = randn(dev, 3, b, kvh, s, d, seed=1)[1]
    v = randn(dev, 3, b, kvh, s, d, seed=2)[1]
    q = randn(dev, b, kvh * g, d)
    valid = torch.tensor([1, 63, 64, 1000], dtype=torch.int32, device=dev)
    clean = kops.decode_attention(q, k, v, valid, layout="bksd")
    for i, n in enumerate([1, 63, 64, 1000]):
        k[i, :, n:] = float("nan")
        v[i, :, n:] = float("nan")
    dirty = kops.decode_attention(q, k, v, valid, layout="bksd")
    torch.cuda.synchronize()
    assert bool(torch.isfinite(dirty).all())
    assert torch.equal(clean, dirty)


def test_decode_wrappers_refuse_what_the_kernels_do_not_take(dev):
    q = torch.zeros(2, 8, 64, device=dev)
    k = torch.zeros(2, 4, 16, 64, device=dev)
    with pytest.raises(TypeError):
        kops.decode_attention(q, k.double(), k.double(), 4, layout="bksd")
    with pytest.raises(ValueError):
        kops.decode_attention(q, k, k, 0, layout="bksd")
    with pytest.raises(ValueError):
        kops.decode_attention(q, k.transpose(2, 3), k.transpose(2, 3), 4,
                              layout="bksd")
