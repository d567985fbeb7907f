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


# B1 at both routes: large M (tiled), LeNet's dense layers at M 1, 8, 16
# (split-K), a ragged K, N not a multiple of 4, and transposed weights
MATMUL_SHAPES = [(37, 75, 19, False), (1024, 2400, 192, True),
                 (8, 800, 500, False), (1, 800, 500, False),
                 (16, 800, 500, False), (8, 500, 10, False),
                 (16, 500, 10, False), (8, 803, 500, False),
                 (8, 800, 500, True), (3, 2401, 65, True),
                 (5, 3000, 37, False)]


def _matmul_operands(dev, m, k, n, transposed):
    a = randn(dev, m, k).relu()
    b = randn(dev, n, k, seed=1).t() if transposed else randn(dev, k, n, seed=1)
    return a, b * (2 / k) ** 0.5, randn(dev, n, seed=2)


@pytest.mark.parametrize("act", ["none", "relu", "silu", "gelu"])
@pytest.mark.parametrize("m,k,n,transposed", MATMUL_SHAPES)
def test_matmul_kernel(dev, m, k, n, transposed, act):
    a, b, bias = _matmul_operands(dev, m, k, n, transposed)
    close(kops.matmul(a, b, bias, activation=act),
          ref.matmul_ref(a, b, bias, activation=act), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("m,k,n,transposed", MATMUL_SHAPES)
def test_matmul_routes_agree_and_rerun_bit_equal(dev, m, k, n, transposed):
    """Every route the shape admits (the tiled kernel; split-K with the
    planned, one and two slices) against the plain version, each run twice
    bit-equal; the planned route is the one the wrapper takes."""
    from repro_torch.kernels import matmul as mm
    a, b, bias = _matmul_operands(dev, m, k, n, transposed)
    want = ref.matmul_ref(a, b, bias, activation="relu")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    planned = mm.plan(m, n, k, sms)
    routes = {0, planned} | {s for s in (1, 2) if m <= mm.SPLIT_MAX_M
                             and -(-k // s) <= mm.MAX_SPAN}
    for splits in sorted(routes):
        got = mm.launch(a, b, bias, activation="relu", splits=splits)
        again = mm.launch(a, b, bias, activation="relu", splits=splits)
        close(got, want, rtol=1e-4, atol=1e-4)
        assert torch.equal(got, again), splits
    assert torch.equal(kops.matmul(a, b, bias, activation="relu"),
                       mm.launch(a, b, bias, activation="relu",
                                 splits=planned))


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


# B3's routes, each bit-equal to the plain version (both keep its order):
# the plane reduction at NIN's global pool and at larger planes, the
# windowed kernel at every pool of NIN's and LeNet's paths
PLANE_POOLS = [((8, 10, 8, 8), 8, 1, 0), ((2, 3, 13, 13), 13, 1, 0),
               ((1, 1, 64, 64), 64, 1, 0), ((2, 3, 33, 31), 31, 31, 0)]
WINDOW_POOLS = [((b, c, hw, hw), 3, 2, 1) for b in (1, 8, 64)
                for c, hw in ((96, 32), (192, 16))] + \
    [((8, 20, 24, 24), 2, 2, 0), ((8, 50, 8, 8), 2, 2, 0),
     ((2, 5, 17, 16), 3, 2, 1), ((1, 2, 40, 300), 5, 3, 2)]


@pytest.mark.parametrize("mode", ["max", "avg"])
@pytest.mark.parametrize("shape,k,s,p", PLANE_POOLS + WINDOW_POOLS)
def test_pool_routes_bit_equal(dev, mode, shape, k, s, p):
    from repro_torch.kernels import pool
    x = randn(dev, *shape) * 3
    kw = dict(mode=mode, kernel=k, stride=s, pad=p)
    got = kops.pool2d(x, **kw)
    again = kops.pool2d(x, **kw)               # the cached plan's launch
    want = ref.pool2d_ref(x, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(again, want)
    route = pool._PLANS[(shape, mode, k, s, p)][0].route
    assert route == (pool.ROUTE_PLANE if (shape, k, s, p) in PLANE_POOLS
                     else pool.ROUTE_WINDOW)


@pytest.mark.parametrize("shape,k,s,p", [((8, 10, 8, 8), 8, 1, 0),
                                         ((2, 3, 9, 10), 3, 2, 1),
                                         ((8, 96, 32, 32), 3, 2, 1)])
def test_pool_max_nan_wins(dev, shape, k, s, p):
    x = randn(dev, *shape)
    x[0, 0, 1, 1] = float("nan")
    x[-1, -1, -1, -1] = float("nan")
    kw = dict(mode="max", kernel=k, stride=s, pad=p)
    got, want = kops.pool2d(x, **kw), ref.pool2d_ref(x, **kw)
    torch.cuda.synchronize()
    assert got.isnan().any() and torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got.nan_to_num(0.0), want.nan_to_num(0.0))


def test_elementwise_takes_one_launch_for_any_n(dev):
    """An aligned base with n % 4 = 3: one ew_vec4 launch a call, where the
    tail took a second kernel before."""
    from torch.profiler import ProfilerActivity, profile
    x = randn(dev, 4 * 1283 + 3) * 4
    assert x.data_ptr() % 16 == 0
    kops.elementwise(x, "silu")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            got = kops.elementwise(x, "silu")
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if str(getattr(e, "device_type", "")).endswith("CUDA")
               and "ew_" in e.name]       # (anonymous namespace)::ew_...
    assert len(kernels) == 5 and all("ew_vec4" in k for k in kernels), \
        kernels
    close(got, ref.elementwise_ref(x, "silu"), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("offset", [0, 1])        # 1: unaligned
def test_relu_in_place_and_out_of_place(dev, offset):
    x = (randn(dev, 3 * 7 * 61 + offset) * 3)[offset:]
    x0 = x.clone()
    want = ref.elementwise_ref(x0, "relu")
    out = kops.elementwise(x, "relu")
    torch.cuda.synchronize()
    assert torch.equal(x, x0) and torch.equal(out, want)
    ptr = x.data_ptr()
    same = kops.relu_(x)
    torch.cuda.synchronize()
    assert same is x and x.data_ptr() == ptr and torch.equal(x, want)


@pytest.mark.parametrize("name", ["nin-cifar10", "lenet-mnist"])
def test_inplace_relu_bit_equal_on_the_card(dev, name, monkeypatch):
    """The CNN at batch 8 through Graph.apply on the kernels: every ReLU
    writes into its input without a trace, and the output is bit-equal to
    a traced run's (no layer in place), with the same launches."""
    from repro_torch.configs import get_config
    from repro_torch.core.ops import REGISTRY
    from repro_torch.models import cnn
    g = cnn.graph_for(get_config(name))
    params = {layer: {k: v.to(dev) for k, v in group.items()}
              for layer, group in g.init_params(
                  torch.Generator().manual_seed(0)).items()}
    x = randn(dev, 8, *g.input_shape)
    flags = []
    spec = REGISTRY.op("relu")

    def spy(x, p, a, ctx):
        flags.append(ctx.inplace)
        return spec.backends["cuda"](x, p, a, ctx)
    monkeypatch.setitem(spec.backends, "spy", spy)
    with torch.inference_mode():
        traced = g.apply(params, x, backend="cuda", trace=[])
        kops.reset_launches()
        out = g.apply(params, x, backend={"relu": "spy", "default": "cuda"})
        launches = {k: n for k, n in kops.launches().items() if n}
    torch.cuda.synchronize()
    assert flags == [True] * sum(l.kind == "relu" for l in g.layers)
    assert torch.equal(out, traced)
    assert launches["elementwise"] == len(flags)
    assert launches["pool2d"] == sum(l.kind == "pool" for l in g.layers)


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
    assert counts == {"conv2d": 9, "elementwise": 9, "pool2d": 3,
                      "softmax": 1}
    y_ref = InferenceEngine(store, backend="ref").predict("nin", x)
    close(y, y_ref, rtol=0, atol=1e-5)


def test_lenet_forward_launches_conv_and_dense_kernels(dev, tmp_path):
    from repro_torch.configs import get_config
    from repro_torch.core.engine import InferenceEngine
    from repro_torch.core.importer import to_caffe_json
    from repro_torch.core.modelstore import ModelStore
    from repro_torch.models import cnn
    g = cnn.graph_for(get_config("lenet-mnist"))
    params = g.init_params(torch.Generator().manual_seed(0))
    store = ModelStore(tmp_path)
    store.publish("lenet", to_caffe_json(g, params)[0], params)
    x = np.random.default_rng(0).standard_normal((3, 1, 28, 28)) \
        .astype(np.float32)
    kops.reset_launches()
    y = InferenceEngine(store).predict("lenet", x)
    counts = {k: n for k, n in kops.launches().items() if n}
    assert counts == {"conv2d": 2, "matmul": 2, "elementwise": 1,
                      "pool2d": 2, "softmax": 1}
    y_ref = InferenceEngine(store, backend="ref").predict("lenet", x)
    close(y, y_ref, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# B2: the implicit-GEMM conv kernel against its plain version (im2col +
# matmul_ref) at every conv of NIN and LeNet, rtol 1e-3 / atol 1e-4 (fp32,
# another summation order), with the depth unsplit, split as the shape
# asks, and split 3 ways; two runs of each are bit-equal.
# ---------------------------------------------------------------------------

# (C, H = W, O, K, stride, pad): NIN-CIFAR10's convs, then LeNet-MNIST's
CONVS = [(3, 32, 192, 5, 1, 2), (192, 32, 160, 1, 1, 0),
         (160, 32, 96, 1, 1, 0), (96, 16, 192, 5, 1, 2),
         (192, 16, 192, 1, 1, 0), (192, 8, 192, 3, 1, 1),
         (192, 8, 192, 1, 1, 0), (192, 8, 10, 1, 1, 0),
         (1, 28, 20, 5, 1, 0), (20, 12, 50, 5, 1, 0)]


@pytest.mark.parametrize("batch", [1, 8, 64])
@pytest.mark.parametrize("c,hw,o,k,stride,pad", CONVS)
def test_conv2d_kernel(dev, c, hw, o, k, stride, pad, batch):
    from repro_torch.kernels import conv2d as cv
    x = randn(dev, batch, c, hw, hw).relu()
    w = randn(dev, o, c, k, k, seed=1) * (2 / (c * k * k)) ** 0.5
    b = randn(dev, o, seed=2) * 0.1
    kw = dict(stride=stride, pad=pad)
    want = ref.conv2d_im2col_ref(x, w, b, **kw)
    for splits in (1, None, 3):
        got = cv.launch(x, w, b, splits=splits, **kw)
        again = cv.launch(x, w, b, splits=splits, **kw)
        close(got, want, rtol=1e-3, atol=1e-4)
        assert got.is_contiguous() and torch.equal(got, again)
    close(kops.conv2d(x, w, b, **kw), want, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("act", ["relu", "silu", "gelu"])
def test_conv2d_kernel_epilogues_and_ragged_shapes(dev, act):
    """Activations in the epilogue; a stride-2 conv and planes of a pixel
    count that is not a multiple of 4 (scalar stores, the gather path for
    a 1x1 conv), without bias."""
    from repro_torch.kernels import conv2d as cv
    for c, hw, o, k, stride, pad in ((8, 11, 16, 3, 2, 0), (5, 7, 70, 1, 1, 0),
                                     (3, 9, 33, 5, 1, 2)):
        x = randn(dev, 3, c, hw, hw)
        w = randn(dev, o, c, k, k, seed=1) * 0.2
        for b in (None, randn(dev, o, seed=2)):
            want = ref.conv2d_im2col_ref(x, w, b, stride=stride, pad=pad,
                                         activation=act)
            for splits in (1, 2):
                got = cv.launch(x, w, b, stride=stride, pad=pad,
                                activation=act, splits=splits)
                close(got, want, rtol=1e-3, atol=1e-4)


def test_conv2d_split_count_fills_the_card(dev):
    from repro_torch.kernels import conv2d as cv
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    # NIN's 5x5 96->192 and 3x3 convs at batch 8: 48 and 12 tiles
    assert cv.split_count(192, 8 * 16 * 16, 2400, sms) * 48 <= 2 * sms
    assert cv.split_count(192, 8 * 16 * 16, 2400, sms) >= 2
    assert cv.split_count(192, 8 * 8 * 8, 1728, sms) == 8
    assert cv.split_count(192, 64 * 32 * 32, 75, sms) == 1


def test_conv2d_wrapper_refuses_what_the_kernel_does_not_take(dev):
    x, w = torch.zeros(1, 3, 8, 8, device=dev), torch.zeros(4, 3, 3, 3,
                                                            device=dev)
    with pytest.raises(TypeError):
        kops.conv2d(x.double(), w.double())
    with pytest.raises(ValueError):
        kops.conv2d(x.transpose(2, 3), w)
    with pytest.raises(ValueError):
        kops.conv2d(x, w.cpu())
    with pytest.raises(ValueError):
        kops.conv2d(x, w[:, :2])


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
@pytest.mark.parametrize("b,kvh,g,d", [(1, 4, 8, 64), (8, 4, 8, 64),
                                       (8, 8, 2, 64), (8, 8, 3, 64),
                                       (8, 2, 4, 32), (1, 1, 16, 256),
                                       (8, 1, 16, 256)])
def test_decode_attention_ring_kernel(dev, dtype, layout, b, kvh, g, d):
    s = 1024
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_decode_attention_paged_kernel_head_dim_256(dev, dtype):
    """RecurrentGemma-9B's local attention: 16 query heads on one KV head
    of 256, pages of 16, ragged lanes."""
    b, kvh, g, d, ps, w = 8, 1, 16, 256, 16, 64
    p = 1 + b * w
    shape = (p, kvh, ps, d)
    q = randn(dev, b, kvh * g, d)
    k, v = _cache(dev, shape, dtype, 1), _cache(dev, shape, dtype, 2)
    valid = np.array([1, 1024, 17, 300, 16, 33, 999, 512])
    pt = np.random.default_rng(1).permutation(np.arange(1, p)) \
        .reshape(b, w).astype(np.int32)
    for i, n in enumerate(valid):
        pt[i, -(-n // ps):] = 0
    pt = torch.from_numpy(pt).to(dev)
    vl = torch.from_numpy(valid.astype(np.int32)).to(dev)
    if dtype == torch.int8:
        ks, vs = _scales(dev, shape[:3], 3), _scales(dev, shape[:3], 4)
        got = kops.decode_attention_paged_q8(q, k, v, ks, vs, pt, vl,
                                             layout="bksd")
        want = ref.decode_attention_paged_q8_ref(q, k, v, ks, vs, pt, vl,
                                                 layout="bksd")
    else:
        got = kops.decode_attention_paged(q, k, v, pt, vl, layout="bksd")
        want = ref.decode_attention_paged_ref(q, k, v, pt, vl, layout="bksd")
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


# The split-KV kernel: chunk edges, tickets, determinism, batch
# independence, poisoned lanes and pages, layer views, narrow copies.

DECODE_FORMS = [(paged, dtype) for paged in (False, True)
                for dtype in (torch.float32, torch.bfloat16, torch.int8)]


def _decode_inputs(dev, paged, dtype, valid, *, kvh=4, g=8, d=64, s=1024,
                   ps=16, layout="bksd", seed=0):
    """(wrapper args, plain args, kernel handle) for one call; a paged
    table is a shuffled permutation of the pool's pages 1.. (page 0 the
    garbage page in unused entries)."""
    from repro_torch.kernels import decode_attention as da
    b = len(valid)
    outer = 1 + b * (s // ps) if paged else b
    slots = ps if paged else s
    shape = (outer, kvh, slots, d) if layout == "bksd" else (outer, slots, kvh, d)
    q = randn(dev, b, kvh * g, d, seed=seed)
    k, v = _cache(dev, shape, dtype, seed + 1), _cache(dev, shape, dtype, seed + 2)
    vl = torch.tensor(valid, dtype=torch.int32, device=dev)
    args = [q, k, v]
    if dtype == torch.int8:
        args += [_scales(dev, shape[:3], seed + 3), _scales(dev, shape[:3], seed + 4)]
    if paged:
        w = s // ps
        pt = np.random.default_rng(seed).permutation(np.arange(1, outer))
        pt = pt[:b * w].reshape(b, w).astype(np.int32)
        for i, n in enumerate(valid):
            pt[i, max(0, -(-n // ps)):] = 0
        args.append(torch.from_numpy(pt).to(dev))
    args.append(vl)
    q8 = dtype == torch.int8
    names = {(False, False): ("decode_attention", "RING"),
             (False, True): ("decode_attention_q8", "RING_Q8"),
             (True, False): ("decode_attention_paged", "PAGED"),
             (True, True): ("decode_attention_paged_q8", "PAGED_Q8")}
    name, handle = names[(paged, q8)]
    wrapper = getattr(kops, name)
    plain = getattr(ref, name + "_ref")

    def run(chunk=None, *, a=args):
        if chunk is None:
            return wrapper(*a, layout=layout)
        scales = tuple(a[3:5]) if q8 else None
        table = a[-2] if paged else None
        return da.launch(getattr(da, handle), *a[:3], a[-1], layout=layout,
                         scales=scales, page_table=table, chunk=chunk)
    return args, run, lambda a=args: plain(*a, layout=layout)


@pytest.mark.parametrize("paged,dtype", DECODE_FORMS)
@pytest.mark.parametrize("chunk", [32, 64, 128])
def test_decode_split_chunk_edges(dev, paged, dtype, chunk):
    """Valid lengths on every edge of the chunk (1, C - 1, C, C + 1, 2C,
    the capacity and past it) at each chunk the wrapper may take, against
    the plain version; each launch runs twice, bit-equal (a counter left
    non-zero by one launch would break the next)."""
    cap = 1024
    valid = [1, chunk - 1, chunk, chunk + 1, 2 * chunk, cap - 1, cap, cap + 7]
    args, run, plain = _decode_inputs(dev, paged, dtype, valid)
    want = plain([*args[:-1], args[-1].clamp(max=cap)])
    first = run(chunk)
    again = run(chunk)
    close(first, want, **DECODE_TOL)
    assert torch.equal(first, again)


@pytest.mark.parametrize("paged,dtype", DECODE_FORMS)
def test_decode_split_lane_alone_equals_lane_in_batch(dev, paged, dtype):
    """A lane's output depends on its own K/V and valid_len alone: lane 5
    of a batch of 8 equals the same lane run as a batch of one, bit for
    bit (the chunk comes from the shapes, never from the batch)."""
    valid = [37, 1000, 64, 5, 300, 777, 16, 129]
    args, run, _ = _decode_inputs(dev, paged, dtype, valid)
    batch = run()
    i = 5
    one = [args[0][i:i + 1]]
    if paged:
        one += args[1:-2] + [args[-2][i:i + 1], args[-1][i:i + 1]]
    else:
        one += [x[i:i + 1] for x in args[1:]]
    alone = run(a=one)
    torch.cuda.synchronize()
    assert torch.equal(alone[0], batch[i])


@pytest.mark.parametrize("paged,dtype", DECODE_FORMS)
def test_decode_split_poisoned_lanes(dev, paged, dtype):
    """valid_len 0 gives that lane NaN (and only that lane); on the paged
    route a table entry outside the pool inside a lane's prefix does the
    same, an entry past the prefix is never read."""
    valid = [0, 300, 64, 1000]
    args, run, plain = _decode_inputs(dev, paged, dtype, valid)
    want = plain([*args[:-1], args[-1].clamp(min=1)])
    if paged:
        pt = args[-2]
        pt[2, 1] = pt.new_tensor(10 ** 6)            # in lane 2's prefix
        pt[3, -1] = pt.new_tensor(-5)                # past lane 3's prefix
    got = run()
    torch.cuda.synchronize()
    bad = [0, 2] if paged else [0]
    assert bool(torch.isnan(got[bad]).all())
    good = [i for i in range(4) if i not in bad]
    close(got[good], want[good], **DECODE_TOL)


@pytest.mark.parametrize("paged,dtype", DECODE_FORMS)
def test_decode_split_reads_nothing_past_the_prefix(dev, paged, dtype):
    """NaN (int8: NaN scales) in every stored slot past each lane's
    prefix, on both routes and in layer views of (L, ...) caches, leaves
    the output unchanged and finite."""
    valid = [1, 31, 32, 33, 500, 1000]
    args, run, _ = _decode_inputs(dev, paged, dtype, valid)
    # the same caches as the middle layer of a 3-layer stack
    stacked = [torch.stack([torch.zeros_like(x), x, torch.zeros_like(x)])[1]
               if i in (1, 2) or (dtype == torch.int8 and i in (3, 4)) else x
               for i, x in enumerate(args)]
    clean = run(a=stacked)
    ps = 16
    targets = [3, 4] if dtype == torch.int8 else [1, 2]
    for t in targets:
        buf = stacked[t]
        if paged:
            buf[0] = float("nan")                    # the garbage page
        for i, n in enumerate(valid):
            if paged:
                j, lo = divmod(n, ps)
                if lo:
                    buf[int(stacked[-2][i, j]), :, lo:] = float("nan")
            else:
                buf[i, :, n:] = float("nan")
    dirty = run(a=stacked)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(dirty).all())
    assert torch.equal(clean, dirty)


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("kvh,g,d", [(4, 8, 64), (8, 2, 64), (8, 3, 64),
                                     (2, 4, 32), (1, 16, 256), (1, 32, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_decode_split_every_head_shape(dev, paged, kvh, g, d, dtype):
    """The serving families' heads (TinyLlama, Qwen3, Granite-MoE, the
    reduced Granite, RecurrentGemma's 16/1 heads of 256) and the widest
    group the wrapper takes, both layouts."""
    for layout in ("bksd", "bskd"):
        args, run, plain = _decode_inputs(
            dev, paged, dtype, [1, 1024, 65, 700, 64, 129, 1000, 2],
            kvh=kvh, g=g, d=d, layout=layout)
        close(run(), plain(), **DECODE_TOL)


# The wide route (16 query heads of a KV head on mma.sync, the splits
# merged by a kernel of their own) at RecurrentGemma's heads.
WIDE = dict(kvh=1, g=16, d=256)


@pytest.mark.parametrize("paged,dtype", DECODE_FORMS)
@pytest.mark.parametrize("chunk", [None, 32, 64, 128])
def test_decode_wide_route_chunk_edges_and_reruns(dev, paged, dtype, chunk):
    """Valid lengths on every edge of the wide route's chunk (its plan's,
    and each multiple of 32 it takes), at the capacity and past it,
    against the plain version; each launch runs twice, bit-equal (the
    merge sums the splits in a fixed order)."""
    from repro_torch.kernels import decode_attention as da
    elem = {torch.float32: 4, torch.bfloat16: 2, torch.int8: 1}[dtype]
    p = da.plan(8, 1, 16, 256, elem, slots=16 if paged else 1024,
                page_size=16 if paged else None, width=64,
                scaled=dtype == torch.int8, chunk=chunk)
    assert p.wide and p.chunk % 32 == 0
    if chunk is None and dtype == torch.float32:
        assert p.chunk == 64
    c, cap = p.chunk, 1024
    valid = [1, c - 1, c, c + 1, 2 * c, cap - 1, cap, cap + 7]
    args, run, plain = _decode_inputs(dev, paged, dtype, valid, **WIDE)
    want = plain([*args[:-1], args[-1].clamp(max=cap)])
    first, again = run(chunk), run(chunk)
    close(first, want, **DECODE_TOL)
    assert torch.equal(first, again)


@pytest.mark.parametrize("paged,dtype", DECODE_FORMS)
def test_decode_wide_route_lanes_poison_and_prefix(dev, paged, dtype):
    """On the wide route: lane 5 alone equals lane 5 of the batch bit for
    bit; valid_len 0 (and, paged, a page id outside the pool in a lane's
    prefix) gives that lane NaN and no other; NaN in every stored slot
    past each lane's prefix changes nothing."""
    valid = [37, 1000, 64, 5, 300, 777, 16, 129]
    args, run, plain = _decode_inputs(dev, paged, dtype, valid, **WIDE)
    batch = run()
    i = 5
    one = [args[0][i:i + 1]]
    if paged:
        one += args[1:-2] + [args[-2][i:i + 1], args[-1][i:i + 1]]
    else:
        one += [x[i:i + 1] for x in args[1:]]
    torch.cuda.synchronize()
    assert torch.equal(run(a=one)[0], batch[i])
    bad_args = list(args)
    bad_args[-1] = args[-1].clone()
    bad_args[-1][0] = 0
    bad = [0]
    if paged:
        bad_args[-2] = args[-2].clone()
        bad_args[-2][2, 1] = 10 ** 6
        bad.append(2)
    got = run(a=bad_args)
    torch.cuda.synchronize()
    assert bool(torch.isnan(got[bad]).all())
    keep = [j for j in range(8) if j not in bad]
    assert torch.equal(got[keep], batch[keep])
    targets = [3, 4] if dtype == torch.int8 else [1, 2]
    for t in targets:
        buf = args[t]
        for j, n in enumerate(valid):
            if paged:                  # pages are a lane's own; 0 unused
                for w, page in enumerate(args[-2][j].tolist()):
                    lo = max(n - 16 * w, 0)
                    if page and lo < 16:
                        buf[page, :, lo:] = float("nan")
            else:
                buf[j, :, n:] = float("nan")
    dirty = run()
    torch.cuda.synchronize()
    assert bool(torch.isfinite(dirty).all())
    assert torch.equal(dirty, batch)


@pytest.mark.parametrize("layout", ["bksd", "bskd"])
def test_decode_split_narrow_copies_and_refusals(dev, layout):
    """int8 rows of 40 bytes (head_dim 40) take 8-byte copies and match
    the plain version; caches whose rows do not start on 4-byte
    boundaries (an int8 view one byte and a bf16 view one element off
    their allocation) are refused with ValueError."""
    from repro_torch.kernels import decode_attention as da
    args, run, plain = _decode_inputs(dev, False, torch.int8,
                                      [1, 40, 300, 1000], kvh=2, g=4, d=40,
                                      layout=layout)
    close(run(), plain(), **DECODE_TOL)
    k = args[1]
    assert da.vector_bytes(1, 40, da._strides(k.stride(), layout),
                           k.data_ptr()) == 8
    q = randn(dev, 2, 8, 64)
    for dtype in (torch.int8, torch.bfloat16):
        flat = _cache(dev, (2 * 4 * 16 * 64 + 1,), dtype, 5)
        kv = flat[1:].view(2, 4, 16, 64)
        if dtype == torch.int8:
            sc = _scales(dev, (2, 4, 16), 6)
            with pytest.raises(ValueError, match="4-byte"):
                kops.decode_attention_q8(q, kv, kv, sc, sc, 4, layout="bksd")
        else:
            with pytest.raises(ValueError, match="4-byte"):
                kops.decode_attention(q, kv, kv, 4, layout="bksd")


# ---------------------------------------------------------------------------
# B8 / B9: full-sequence flash attention and its backward against the plain
# versions.  fp32: rtol 1e-4 / atol 1e-5 on outputs and lse, 1e-3 / 1e-4 on
# grads (the JAX suite's bar for the fused backward); bf16: 2e-2 / 3e-2
# (the plain version rounds p to bf16 before the PV product, the kernel
# keeps it in fp32).
# ---------------------------------------------------------------------------

FLASH_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-5),
             torch.bfloat16: dict(rtol=2e-2, atol=3e-2)}
FLASH_GRAD_TOL = {torch.float32: dict(rtol=1e-3, atol=1e-4),
                  torch.bfloat16: dict(rtol=2e-2, atol=3e-2)}


def _qkv(dev, b, s, h, kvh, d, dtype, seed=0):
    return (randn(dev, b, s, h, d, seed=seed).to(dtype),
            randn(dev, b, s, kvh, d, seed=seed + 1).to(dtype),
            randn(dev, b, s, kvh, d, seed=seed + 2).to(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, 48])
@pytest.mark.parametrize("b,s,h,kvh,d", [(1, 1, 32, 4, 64), (2, 5, 32, 4, 64),
                                         (1, 127, 16, 8, 128),
                                         (2, 300, 32, 4, 64),
                                         (2, 5, 8, 1, 32),
                                         (1, 300, 8, 4, 32),
                                         (2, 300, 24, 8, 64),
                                         (1, 127, 8, 2, 32)])
def test_flash_attention_kernels(dev, b, s, h, kvh, d, window, dtype):
    from repro_torch.kernels import flash_attention as fa
    q, k, v = _qkv(dev, b, s, h, kvh, d, dtype)
    do = randn(dev, b, s, h, d, seed=7).to(dtype)
    kw = dict(causal=True, window=window)
    close(kops.flash_attention(q, k, v, **kw).float(),
          ref.flash_attention_ref(q, k, v, **kw).float(), **FLASH_TOL[dtype])
    o, lse = fa.flash_fwd_lse(q, k, v, **kw)
    o_ref, lse_ref = ref.flash_fwd_lse_ref(q, k, v, **kw)
    close(o.float(), o_ref.float(), **FLASH_TOL[dtype])
    close(lse, lse_ref, **FLASH_TOL[torch.float32])
    res = (q, k, v, do, lse_ref, fa.dsum_of(o_ref, do))
    close(fa.flash_dq(*res, **kw).float(), ref.flash_dq_ref(*res, **kw).float(),
          **FLASH_GRAD_TOL[dtype])
    for got, want in zip(fa.flash_dkv(*res, **kw), ref.flash_dkv_ref(*res, **kw)):
        close(got.float(), want.float(), **FLASH_GRAD_TOL[dtype])


# (B, Sq, Sk, H, KV, D, causal, window): Whisper-medium's cross attention
# (300 prompt rows against 1500 frames), rows that see no key (Sq > Sk
# with a causal window: rows 163.. of 300 against 100 keys, window 64),
# and RecurrentGemma-9B's local attention (16/1 heads of 256, window 2048)
FLASH_SQ_SK = [(1, 300, 1500, 16, 16, 64, False, 0),
               (1, 300, 1500, 16, 16, 64, True, 0),
               (2, 300, 100, 4, 2, 64, True, 64),
               (1, 70, 300, 4, 4, 32, False, 48),
               (1, 5, 33, 2, 1, 128, True, 0),
               (1, 2100, 2100, 16, 1, 256, True, 2048),
               (2, 127, 127, 16, 1, 256, True, 0),
               (1, 300, 1500, 16, 16, 256, False, 0),
               (1, 300, 100, 16, 1, 256, True, 64)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,sk,h,kvh,d,causal,window", FLASH_SQ_SK)
def test_flash_attention_kernels_sq_sk_and_head_dim_256(
        dev, b, sq, sk, h, kvh, d, causal, window, dtype):
    from repro_torch.kernels import flash_attention as fa
    q = randn(dev, b, sq, h, d, seed=11).to(dtype)
    k = randn(dev, b, sk, kvh, d, seed=12).to(dtype)
    v = randn(dev, b, sk, kvh, d, seed=13).to(dtype)
    do = randn(dev, b, sq, h, d, seed=14).to(dtype)
    kw = dict(causal=causal, window=window)
    close(kops.flash_attention(q, k, v, **kw).float(),
          ref.flash_attention_ref(q, k, v, **kw).float(), **FLASH_TOL[dtype])
    o, lse = fa.flash_fwd_lse(q, k, v, **kw)
    o_ref, lse_ref = ref.flash_fwd_lse_ref(q, k, v, **kw)
    close(o.float(), o_ref.float(), **FLASH_TOL[dtype])
    close(lse, lse_ref, **FLASH_TOL[torch.float32])
    res = (q, k, v, do, lse_ref, fa.dsum_of(o_ref, do))
    close(fa.flash_dq(*res, **kw).float(), ref.flash_dq_ref(*res, **kw).float(),
          **FLASH_GRAD_TOL[dtype])
    for got, want in zip(fa.flash_dkv(*res, **kw), ref.flash_dkv_ref(*res, **kw)):
        assert got.shape == (b, sk, kvh, d)
        close(got.float(), want.float(), **FLASH_GRAD_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,sk,h,kvh,d,causal,window", [
    (2, 300, 300, 32, 4, 64, True, 0), (1, 127, 127, 16, 8, 128, True, 48),
    (1, 300, 1500, 8, 8, 32, False, 0), (1, 300, 100, 16, 1, 256, True, 64)])
def test_flash_backward_reruns_bit_equal(dev, b, sq, sk, h, kvh, d, causal,
                                         window, dtype):
    """dq and dk/dv sum in a fixed order (no float atomics): two runs on
    the same inputs are bit-equal, at every head-dim route."""
    from repro_torch.kernels import flash_attention as fa
    q = randn(dev, b, sq, h, d, seed=31).to(dtype)
    k = randn(dev, b, sk, kvh, d, seed=32).to(dtype)
    v = randn(dev, b, sk, kvh, d, seed=33).to(dtype)
    do = randn(dev, b, sq, h, d, seed=34).to(dtype)
    kw = dict(causal=causal, window=window)
    o, lse = fa.flash_fwd_lse(q, k, v, **kw)
    res = (q, k, v, do, lse, fa.dsum_of(o, do))
    first = (fa.flash_dq(*res, **kw),) + fa.flash_dkv(*res, **kw)
    second = (fa.flash_dq(*res, **kw),) + fa.flash_dkv(*res, **kw)
    torch.cuda.synchronize()
    for x, y in zip(first, second):
        assert torch.equal(x, y)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,sk,h,kvh,d,causal,window", [
    (2, 300, 300, 32, 4, 64, True, 0), (1, 127, 127, 16, 8, 128, True, 48),
    (1, 300, 1500, 8, 8, 32, False, 0), (1, 300, 100, 16, 1, 256, True, 64),
    (4, 2048, 2048, 32, 4, 64, True, 0)])
def test_flash_forward_reruns_bit_equal(dev, b, sq, sk, h, kvh, d, causal,
                                        window, dtype):
    """B8 and B9's forward take no float atomics: two runs on the same
    inputs are bit-equal (o and lse), at every head-dim route and at the
    train shape."""
    from repro_torch.kernels import flash_attention as fa
    q = randn(dev, b, sq, h, d, seed=35).to(dtype)
    k = randn(dev, b, sk, kvh, d, seed=36).to(dtype)
    v = randn(dev, b, sk, kvh, d, seed=37).to(dtype)
    kw = dict(causal=causal, window=window)
    first = (kops.flash_attention(q, k, v, **kw),) + fa.flash_fwd_lse(q, k, v, **kw)
    second = (kops.flash_attention(q, k, v, **kw),) + fa.flash_fwd_lse(q, k, v, **kw)
    torch.cuda.synchronize()
    for x, y in zip(first, second):
        assert torch.equal(x, y)


def test_flash_forward_at_the_train_shape(dev):
    """B8 and B9's forward at TinyLlama's train shape (batch 4 x 2048,
    32/4 heads of 64, causal, fp32) against the plain versions."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v = _qkv(dev, 4, 2048, 32, 4, 64, torch.float32, seed=45)
    o_ref, lse_ref = ref.flash_fwd_lse_ref(q, k, v)
    close(kops.flash_attention(q, k, v), o_ref, **FLASH_TOL[torch.float32])
    o, lse = fa.flash_fwd_lse(q, k, v)
    close(o, o_ref, **FLASH_TOL[torch.float32])
    close(lse, lse_ref, **FLASH_TOL[torch.float32])


def _fp64_error(q, k, v, o):
    """(rms of o - exact, slope of o against exact less 1), exact being
    causal attention in fp64 on the same inputs, one batch row at a time."""
    b, s, h, d = q.shape
    g = h // k.shape[2]
    future = torch.ones(s, s, dtype=torch.bool, device=q.device).triu(1)
    sq = gw = ww = 0.0
    for i in range(b):
        qi = q[i].double().transpose(0, 1)
        ki = k[i].double().repeat_interleave(g, dim=1).transpose(0, 1)
        vi = v[i].double().repeat_interleave(g, dim=1).transpose(0, 1)
        sc = (qi @ ki.transpose(1, 2)) / d ** 0.5
        exact = torch.softmax(sc.masked_fill_(future, float("-inf")), -1) @ vi
        got = o[i].double().transpose(0, 1)
        sq += float(((got - exact) ** 2).sum())
        gw += float((got * exact).sum())
        ww += float((exact * exact).sum())
    return (sq / o.numel()) ** 0.5, gw / ww - 1.0


def test_flash_forward_accuracy_against_fp64_at_the_train_shape(dev):
    """B8 and B9's forward at TinyLlama's train shape (fp32, inputs
    uniform in [-2, 2)) against causal attention in fp64: o's rms error
    at most 1e-7 and its slope within 5e-7 of 1.  The shipped 3xTF32
    kernel reads rms 3.1e-8 and slope -1.2e-7 there
    (benchmarks/flash_fwd_variants.cu); the FFMA kernel 6.7e-8.  The
    bars hold the structure of the tensor-core sums (small terms first,
    hi.hi spread over several accumulators), which the plain-version
    tolerance does not see: with every term on one accumulator the
    kernel passed it and still parted greedy int8 streams from ref's."""
    from repro_torch.kernels import flash_attention as fa
    g = torch.Generator().manual_seed(46)
    q, k, v = (torch.rand(4, 2048, n, 64, generator=g).mul_(4).sub_(2).to(dev)
               for n in (32, 4, 4))
    for o in (kops.flash_attention(q, k, v), fa.flash_fwd_lse(q, k, v)[0]):
        rms, slope = _fp64_error(q, k, v, o)
        assert rms <= 1e-7 and abs(slope) <= 5e-7, (rms, slope)


def test_flash_backward_at_the_train_shape(dev):
    """dq and dk/dv at TinyLlama's train shape (batch 4 x 2048, 32/4
    heads of 64, causal, fp32) against the plain versions."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v = _qkv(dev, 4, 2048, 32, 4, 64, torch.float32, seed=41)
    do = randn(dev, 4, 2048, 32, 64, seed=44)
    o, lse = fa.flash_fwd_lse(q, k, v)
    res = (q, k, v, do, lse, fa.dsum_of(o, do))
    close(fa.flash_dq(*res), ref.flash_dq_ref(*res),
          **FLASH_GRAD_TOL[torch.float32])
    for got, want in zip(fa.flash_dkv(*res), ref.flash_dkv_ref(*res)):
        close(got, want, **FLASH_GRAD_TOL[torch.float32])


def test_flash_attention_trainable_sq_sk_grads_on_the_card(dev):
    """B9 through autograd at Sq != Sk and at head_dim 256, against
    autograd of the materialized attention.  (Rows that see no key take
    the reference's gradients, not autograd's: the kernel test above holds
    them against the plain versions.)"""
    from repro_torch.models.common import attention_full
    for b, sq, sk, h, kvh, d, causal, window in (
            (1, 300, 100, 4, 2, 64, True, 256),
            (1, 200, 700, 8, 8, 64, False, 0),
            (1, 300, 300, 16, 1, 256, True, 128)):
        q = randn(dev, b, sq, h, d, seed=21)
        k = randn(dev, b, sk, kvh, d, seed=22)
        v = randn(dev, b, sk, kvh, d, seed=23)
        grads = []
        for fn in (lambda *x: kops.flash_attention_trainable(*x, causal,
                                                             window),
                   lambda *x: attention_full(*x, causal=causal,
                                             window=window)):
            leaves = [x.clone().requires_grad_() for x in (q, k, v)]
            o = fn(*leaves)
            torch.sin(o).sum().backward()
            grads.append([o.detach()] + [x.grad for x in leaves])
        close(grads[0][0], grads[1][0], **FLASH_TOL[torch.float32])
        for got, want in zip(grads[0][1:], grads[1][1:]):
            close(got, want, **FLASH_GRAD_TOL[torch.float32])


def test_flash_attention_trainable_grads_on_the_card(dev):
    """B9 through autograd against autograd of the materialized attention,
    GQA 8:1 with a window."""
    from repro_torch.models.common import attention_full
    q, k, v = _qkv(dev, 2, 200, 32, 4, 64, torch.float32, seed=3)
    grads = []
    for fn in (lambda *x: kops.flash_attention_trainable(*x, True, 64),
               lambda *x: attention_full(*x, causal=True, window=64)):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        o = fn(*leaves)
        torch.sin(o).sum().backward()
        grads.append([o.detach()] + [x.grad for x in leaves])
    close(grads[0][0], grads[1][0], **FLASH_TOL[torch.float32])
    for got, want in zip(grads[0][1:], grads[1][1:]):
        close(got, want, **FLASH_GRAD_TOL[torch.float32])


def test_flash_attention_is_causal(dev):
    """A perturbed last token leaves every earlier output unchanged."""
    q, k, v = _qkv(dev, 1, 130, 16, 8, 128, torch.float32, seed=5)
    base = kops.flash_attention(q, k, v)
    k2, v2 = k.clone(), v.clone()
    k2[:, -1] += 10.0
    v2[:, -1] += 10.0
    pert = kops.flash_attention(q, k2, v2)
    torch.cuda.synchronize()
    assert torch.equal(base[:, :-1], pert[:, :-1])
    assert float((base[:, -1] - pert[:, -1]).abs().max()) > 1e-3


def test_flash_wrappers_refuse_what_the_kernels_do_not_take(dev):
    q, k, v = _qkv(dev, 1, 8, 4, 2, 48, torch.float32)
    with pytest.raises(ValueError):                      # head_dim 48
        kops.flash_attention(q, k, v)
    q, k, v = _qkv(dev, 1, 8, 4, 2, 64, torch.float32)
    with pytest.raises(TypeError):
        kops.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError):                      # H not a multiple of KV
        kops.flash_attention(q[:, :, :3], k, v)
    with pytest.raises(ValueError):
        kops.flash_attention(q, k.cpu(), v)


# ---------------------------------------------------------------------------
# the command lines with their defaults: reduced configs, head_dim 32
# ---------------------------------------------------------------------------


def test_serve_cli_bootstraps_and_prefills_on_the_card(dev, tmp_path):
    from repro_torch.launch import serve
    kops.reset_launches()
    serve.main(["--store", str(tmp_path), "--model", "tinyllama-1.1b",
                "--requests", "2", "--max-new", "4"])
    counts = {k: n for k, n in kops.launches().items() if n}
    assert set(counts) == {"flash_attention", "decode_attention"}


def test_train_cli_runs_on_the_card_and_matches_ref(dev, tmp_path):
    """The trainer's defaults (reduced TinyLlama, 2 layers) on B9: launches
    and losses against a ``ref`` run from the same seed (rtol 1e-4)."""
    from repro_torch.launch import train
    kops.reset_launches()
    got = train.main(["--steps", "2", "--batch", "2", "--seq", "64",
                      "--publish", str(tmp_path)])
    counts = {k: n for k, n in kops.launches().items() if n}
    assert counts == {"flash_attention_fwd": 8, "flash_attention_dq": 4,
                      "flash_attention_dkv": 4}
    _, want = train.train("tinyllama-1.1b", steps=2, batch=2, seq=64,
                          device=dev, backend="ref")
    np.testing.assert_allclose(got, want, rtol=1e-4)


# ---------------------------------------------------------------------------
# B10: the chunked RWKV-6 WKV, and the RWKV-6 family on it
# ---------------------------------------------------------------------------


def _wkv_inputs(dev, b, t, h, n, *, w_zero=False, seed=0,
                dtype=torch.float32):
    """r, k, v ~ N(0, 1) drawn separately (r != k), decays uniform in
    (0, 1), every third token's 0 with ``w_zero``; the bonus u fp32."""
    g = torch.Generator().manual_seed(seed)
    r, k, v = (torch.randn(b, t, h, n, generator=g) for _ in range(3))
    w = torch.rand(b, t, h, n, generator=g)
    if w_zero:
        w[:, ::3] = 0.0
    u = torch.randn(h, n, generator=g)
    return [x.to(dev, dtype) for x in (r, k, v, w)] + [u.to(dev)]


@pytest.mark.parametrize("w_zero", [False, True], ids=["w", "w0"])
@pytest.mark.parametrize("b,t,h,n", [(1, 1, 40, 64), (2, 5, 8, 32),
                                     (1, 16, 8, 32), (3, 33, 40, 64),
                                     (2, 300, 8, 32), (1, 300, 40, 64)])
def test_rwkv6_chunked_kernel(dev, b, t, h, n, w_zero):
    """B10 against its plain version evaluated in fp64 on the same fp32
    inputs (rtol 1e-4, atol 1e-5: the kernel's arithmetic is fp64, the
    fp32 plain version is itself ~1e-5 off near cancellations and w = 0).
    r != k, so a transposed state fails.  ``out`` is the head of a
    NaN-filled buffer whose tail must stay NaN: no row past T is
    written."""
    from repro_torch.kernels import rwkv6_chunk as rw
    x = _wkv_inputs(dev, b, t, h, n, w_zero=w_zero, seed=t + n)
    want_o, want_s = ref.rwkv6_chunked_ref(*(y.double() for y in x))
    size = b * t * h * n
    buf = torch.full((size + 4096,), float("nan"), device=dev)
    out = buf[:size].view(b, t, h, n)
    state = torch.full((b, h, n, n), float("nan"), device=dev)
    rw.rwkv6_chunked_into(*x, out, state)
    close(out.double(), want_o, rtol=1e-4, atol=1e-5)
    close(state.double(), want_s, rtol=1e-4, atol=1e-5)
    assert torch.isnan(buf[size:]).all()
    o2, s2 = kops.rwkv6_chunked(*x)
    torch.cuda.synchronize()
    assert torch.equal(o2, out) and torch.equal(s2, state)


def test_rwkv6_kept_records_survive_a_larger_capture(dev):
    """Two prefill buckets captured small then large on one stream, both
    within KEEP_BYTES: the larger capture must not replace the kept
    records buffer that the small graph holds.  With freed memory filled
    with NaN, the small graph's replay equals an eager launch bit for
    bit, and the kept buffer is the one made at the first launch."""
    from repro_torch.core.jit import capture
    from repro_torch.kernels import rwkv6_chunk as rw
    small = _wkv_inputs(dev, 1, 32, 40, 64, seed=1)
    large = _wkv_inputs(dev, 1, 1024, 40, 64, seed=2)
    assert rw.plan(1, 32, 40, 64).workspace < \
        rw.plan(1, 1024, 40, 64).workspace <= rw.KEEP_BYTES
    want = [t.clone() for t in kops.rwkv6_chunked(*small)]
    _, g_small = capture(lambda: kops.rwkv6_chunked(*small), dev)
    kept = dict(rw._kept)
    _, g_large = capture(lambda: kops.rwkv6_chunked(*large), dev)
    assert {k: v.data_ptr() for k, v in rw._kept.items()} == \
        {k: v.data_ptr() for k, v in kept.items()}
    junk = [torch.full((1 << 24,), float("nan"), device=dev)
            for _ in range(4)]
    g_large.replay()
    got = g_small.replay()
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    del junk


def test_rwkv6_chunked_kernel_bf16(dev):
    """bf16 r, k, v, w with fp32 arithmetic: out in bf16 within its
    rounding (2^-9 relative), the fp32 state at the fp32 bar."""
    x = _wkv_inputs(dev, 2, 45, 8, 64, seed=4, dtype=torch.bfloat16)
    want_o, want_s = ref.rwkv6_chunked_ref(*(y.double() for y in x))
    out, state = kops.rwkv6_chunked(*x)
    assert out.dtype == torch.bfloat16 and state.dtype == torch.float32
    close(out.double(), want_o, rtol=4e-3, atol=1e-3)
    close(state.double(), want_s, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("w_zero", [False, True], ids=["w", "w0"])
@pytest.mark.parametrize("b,t,h,n", [(2, 45, 8, 64), (1, 300, 40, 64),
                                     (3, 33, 8, 32)])
def test_rwkv6_chunked_kernel_bf16_with_fp32_decay(dev, b, t, h, n, w_zero):
    """bf16 r, k, v beside an fp32 decay (a bf16 RWKV-6's): out in bf16
    at the all-bf16 bar, the fp32 state at the fp32 bar, against the
    plain version in fp64 on the same inputs; a rerun and inputs that do
    not start on 16 bytes (the plain-load path) give the same bits."""
    x = _wkv_inputs(dev, b, t, h, n, w_zero=w_zero, seed=5 + t)
    x = [y.bfloat16() for y in x[:3]] + x[3:]
    assert x[3].dtype == torch.float32
    want_o, want_s = ref.rwkv6_chunked_ref(*(y.double() for y in x))
    out, state = kops.rwkv6_chunked(*x)
    assert out.dtype == torch.bfloat16 and state.dtype == torch.float32
    close(out.double(), want_o, rtol=4e-3, atol=1e-3)
    close(state.double(), want_s, rtol=1e-4, atol=1e-5)
    o2, s2 = kops.rwkv6_chunked(*x)
    shifted = [torch.cat([y.new_zeros(1), y.flatten()])[1:].view(y.shape)
               for y in x[:4]]
    odd = kops.rwkv6_chunked(*shifted, x[4])
    torch.cuda.synchronize()
    assert torch.equal(o2, out) and torch.equal(s2, state)
    assert torch.equal(odd[0], out) and torch.equal(odd[1], state)


def test_rwkv6_bf16_prefill_on_b10_equals_ref(dev):
    """A bf16 reduced RWKV-6 prefill: each layer's time mix on the same
    input through B10 (bf16 r, k, v, fp32 decay) against ``ref``'s plain
    scan, output and wkv state at the bf16 bar; B10 launched once a
    layer on ``cuda``; the whole prefill's logits at the bar too."""
    from repro_torch import models
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.models import common as cm
    from repro_torch.models import rwkv6 as rw6
    cfg = reduced(get_config("rwkv6-3b"))
    params = models.init_params(cfg, torch.Generator(dev).manual_seed(3),
                                dtype=torch.bfloat16, device=dev)
    toks = torch.arange(2, 302, device=dev)[None] % cfg.vocab_size
    with torch.no_grad():
        x = params["embed"][toks]
        for l in range(cfg.num_layers):
            lp = {k: w[l] for k, w in params["layers"].items()}
            xn = cm.rms_norm(x, lp["ln1"], cfg.norm_eps)
            kops.reset_launches()
            got = rw6.time_mix(cfg, lp, xn, backend="cuda")
            assert kops.launches()["rwkv6_chunked"] == 1
            want = rw6.time_mix(cfg, lp, xn, backend="ref")
            for i in (0, 2):
                close(got[i].float(), want[i].float(), rtol=2e-2, atol=3e-2)
            x = x + want[0]
            x = x + rw6.channel_mix(
                cfg, lp, cm.rms_norm(x, lp["ln2"], cfg.norm_eps))[0]
        kops.reset_launches()
        lg, _ = rw6.prefill(cfg, params, toks, 512, backend="cuda")
        assert kops.launches()["rwkv6_chunked"] == cfg.num_layers
        lr, _ = rw6.prefill(cfg, params, toks, 512, backend="ref")
    close(lg.float(), lr.float(), rtol=2e-2, atol=3e-2)


@pytest.mark.parametrize("n", [32, 64])
@pytest.mark.parametrize("t", [15, 16, 17, 33])
def test_rwkv6_column_blocks_reruns_and_lanes_bit_equal(dev, t, n):
    """B10's sums do not depend on the batch or the inputs' alignment: at
    T around the chunk edges, both column blocks of a head, a rerun
    (also into the caller's buffers), a lane run alone, and inputs that
    do not start on 16 bytes (the plain-load path) give the same bits."""
    from repro_torch.kernels import rwkv6_chunk as rw
    x = _wkv_inputs(dev, 3, t, 8, n, w_zero=t % 2 == 1, seed=t * n)
    o, st = kops.rwkv6_chunked(*x)
    got = rw.rwkv6_chunked_into(*x, torch.empty_like(o), torch.empty_like(st))
    assert torch.equal(got[0], o) and torch.equal(got[1], st)
    o2, st2 = kops.rwkv6_chunked(*x)
    lone = kops.rwkv6_chunked(*(y[1:2] for y in x[:4]), x[4])
    shifted = [torch.cat([y.new_zeros(1), y.flatten()])[1:].view(y.shape)
               for y in x[:4]]
    odd = kops.rwkv6_chunked(*shifted, x[4])
    torch.cuda.synchronize()
    assert torch.equal(o2, o) and torch.equal(st2, st)
    assert torch.equal(lone[0], o[1:2]) and torch.equal(lone[1], st[1:2])
    assert torch.equal(odd[0], o) and torch.equal(odd[1], st)


def test_rwkv6_chunked_kernel_at_8_by_2048(dev):
    """The long batched shape (8 prompts of 2048, RWKV-6 3B's heads),
    w = 0 entries included, against the fp64 plain version at the bar."""
    x = _wkv_inputs(dev, 8, 2048, 40, 64, w_zero=True, seed=82)
    out, state = kops.rwkv6_chunked(*x)
    want_o, want_s = ref.rwkv6_chunked_ref(*(y.double() for y in x))
    close(out.double(), want_o, rtol=1e-4, atol=1e-5)
    close(state.double(), want_s, rtol=1e-4, atol=1e-5)


def test_rwkv6_record_size_matches_the_wrapper(dev):
    """The workspace's record, as the kernel lays it out, is the size the
    wrapper allocates."""
    import ctypes
    from repro_torch.kernels import _build
    from repro_torch.kernels import rwkv6_chunk as rw
    _build.build()
    fn = _build._library.dlk_rwkv6_record_bytes
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    assert [fn(n) for n in rw.HEAD_SIZES] == [rw.record_bytes(n)
                                              for n in rw.HEAD_SIZES]


def test_rwkv6_wrappers_refuse_what_the_kernel_does_not_take(dev):
    from repro_torch.models import rwkv6 as rw6
    r, k, v, w, u = _wkv_inputs(dev, 1, 8, 2, 48)
    with pytest.raises(ValueError, match=r"\(32, 64\)"):   # head size 48
        kops.rwkv6_chunked(r, k, v, w, u)
    r, k, v, w, u = _wkv_inputs(dev, 1, 8, 2, 32)
    with pytest.raises(TypeError):
        kops.rwkv6_chunked(r.half(), k.half(), v.half(), w.half(), u)
    with pytest.raises(ValueError):
        kops.rwkv6_chunked(r, k[:, :4], v, w, u)
    with pytest.raises(ValueError):
        kops.rwkv6_chunked(r, k.cpu(), v, w, u)
    s0 = torch.zeros(1, 2, 32, 32, device=dev)
    with pytest.raises(ValueError, match="zero state"):
        rw6.wkv_named(r, k, v, w, u, s0=s0, backend="cuda")


def test_rwkv6_served_on_the_kernels_equals_ref(dev):
    """Reduced RWKV-6 (N 32) through ServingEngine: greedy tokens on the
    kernels equal ``ref``'s, B10 launches num_layers x prefills there and
    never on ``ref``."""
    from repro_torch import models
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.serving.engine import Request, ServingEngine
    cfg = reduced(get_config("rwkv6-3b"))
    params = models.init_params(cfg, torch.Generator(dev).manual_seed(0),
                                device=dev)
    outs, counts = {}, {}
    for backend in (None, "ref"):
        reqs = [Request(uid=i, prompt=list(range(3, 3 + n)), max_new_tokens=8)
                for i, n in enumerate((5, 17, 1, 40))]
        kops.reset_launches()
        ServingEngine(cfg, params, max_batch=2, cache_len=64,
                      attn_backend=backend, device=dev).generate_batch(reqs)
        counts[backend] = kops.launches()["rwkv6_chunked"]
        outs[backend] = [r.output for r in reqs]
    assert outs[None] == outs["ref"]
    assert counts == {None: cfg.num_layers * 4, "ref": 0}


def test_rwkv6_train_cli_matches_ref(dev, tmp_path):
    """launch.train --arch rwkv6-3b (reduced): losses on the card equal a
    ``ref`` run's; with grad on, the WKV is the plain chunked scan on
    every backend, so B10 is not launched."""
    from repro_torch.launch import train
    kops.reset_launches()
    got = train.main(["--arch", "rwkv6-3b", "--steps", "2", "--batch", "2",
                      "--seq", "64", "--publish", str(tmp_path)])
    assert kops.launches()["rwkv6_chunked"] == 0
    _, want = train.train("rwkv6-3b", steps=2, batch=2, seq=64, device=dev,
                          backend="ref")
    np.testing.assert_allclose(got, want, rtol=1e-4)


@pytest.mark.parametrize("m,k,n", [(128, 128, 128), (64, 512, 256),
                                   (1, 1, 1), (37, 130, 75), (17, 1000, 3),
                                   (8, 1536, 1536), (300, 512, 1536)])
def test_int8_matmul_kernel_is_bit_equal(dev, m, k, n):
    """B11 against its plain version: the int32 sums are exact and the
    epilogue rounds in the same order, so the results are equal."""
    g = torch.Generator().manual_seed(m + k + n)
    a = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
    b = torch.randint(-127, 128, (k, n), generator=g, dtype=torch.int8)
    sa = torch.rand(m, generator=g) + 0.01
    sb = torch.rand(n, generator=g) + 0.01
    args = [x.to(dev) for x in (a, b, sa, sb)]
    before = kops.launches()["int8_matmul"]
    got = kops.int8_matmul(*args)
    assert kops.launches()["int8_matmul"] == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got, ref.int8_matmul_ref(*args))
    assert torch.equal(got.cpu(), ref.int8_matmul_ref(a, b, sa, sb))
    full = torch.full((8, 512), 127, dtype=torch.int8, device=dev)
    ones = torch.ones(8, device=dev)
    assert torch.equal(kops.int8_matmul(full, full.t().contiguous(), ones,
                                        ones),
                       torch.full((8, 8), 512.0 * 127 * 127, device=dev))


def _int8_operands(dev, m, k, n, seed, shift_a=0, shift_b=0):
    """Random int8 operands whose bases sit ``shift`` bytes past an
    aligned allocation, and scales."""
    g = torch.Generator().manual_seed(seed)
    a = torch.randint(-127, 128, (m * k + shift_a,), generator=g,
                      dtype=torch.int8).to(dev)[shift_a:].view(m, k)
    b = torch.randint(-127, 128, (k * n + shift_b,), generator=g,
                      dtype=torch.int8).to(dev)[shift_b:].view(k, n)
    sa = (torch.rand(m, generator=g) + 0.01).to(dev)
    sb = (torch.rand(n, generator=g) + 0.01).to(dev)
    return [a, b, sa, sb]


@pytest.mark.parametrize("m,k,n,shift_a,shift_b,route", [
    (37, 130, 75, 0, 0, 0),       # K and N off 16: byte loads for both
    (17, 1000, 3, 0, 0, 0),
    (64, 512, 256, 1, 0, 2),      # A's base off 16 bytes
    (64, 512, 256, 0, 3, 1),      # B's base off 16 bytes
    (300, 1536, 1536, 0, 0, 3),
])
def test_int8_routes_bit_equal(dev, m, k, n, shift_a, shift_b, route):
    from repro_torch.kernels import int8_matmul as i8
    args = _int8_operands(dev, m, k, n, m + k + n, shift_a, shift_b)
    assert i8.vector_route(args[0], args[1]) == route
    got = kops.int8_matmul(*args)
    again = kops.int8_matmul(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.int8_matmul_ref(*args))
    assert torch.equal(again, got)


def test_int8_split_k_at_a_decode_batch(dev):
    """M 8 against Granite's 1536 x 1536: the plan splits K; the split
    result equals the plain version bit for bit, reruns are bit-equal,
    and the workspace is left at 0."""
    from repro_torch.kernels import int8_matmul as i8
    from repro_torch.kernels._build import sm_count
    args = _int8_operands(dev, 8, 1536, 1536, 81)
    assert i8.plan(8, 1536, 1536, sm_count(dev.index or 0)).splits > 1
    got = kops.int8_matmul(*args)
    for other in (kops.int8_matmul(*args), ref.int8_matmul_ref(*args)):
        assert torch.equal(got, other)
    torch.cuda.synchronize()
    assert all(bool((w == 0).all()) for ws in i8._workspaces.values()
               for w in ws)


@pytest.mark.parametrize("n", [24, 32])
def test_int8_all_127_at_the_largest_exact_k(dev, n):
    """127 * 127 * 133,144 is the largest int32 sum of int8 products that
    does not wrap: exact through the plan's split over K, and equal to
    the plain version's unsplit sum."""
    k = 133_144
    a = torch.full((5, k), 127, dtype=torch.int8, device=dev)
    a[2] = -127
    b = torch.full((k, n), 127, dtype=torch.int8, device=dev)
    ones = torch.ones(5, device=dev), torch.ones(n, device=dev)
    want = torch.full((5, n), float(127 * 127 * k), device=dev)
    want[2] = -want[2]
    assert torch.equal(kops.int8_matmul(a, b, *ones), want)
    assert torch.equal(kops.int8_matmul(a, b, *ones),
                       ref.int8_matmul_ref(a, b, *ones))


def test_int8_wrapper_refuses_what_the_kernel_does_not_take(dev):
    a = torch.zeros(4, 16, dtype=torch.int8, device=dev)
    bt = torch.zeros(3, 16, dtype=torch.int8, device=dev)
    sa, sb = torch.ones(4, device=dev), torch.ones(3, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        kops.int8_matmul(a, bt.t(), sa, sb)
    with pytest.raises(ValueError, match="CUDA device"):
        kops.int8_matmul(a, bt.t().contiguous().cpu(), sa, sb)


def test_moe_served_on_the_kernels_equals_ref(dev):
    """Reduced Granite-MoE (8/2 heads of 32) through ServingEngine in
    the ring fp32 and paged int8 forms: greedy tokens on the kernels
    equal ``ref``'s; B8 launches num_layers x prefills and the decode
    kernels num_layers x decode steps there, none on ``ref``; 8 ticks
    run under sync debug mode "error"."""
    from repro_torch import models
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.serving.engine import Request, ServingEngine
    cfg = reduced(get_config("granite-moe-3b-a800m"))
    params = models.init_params(cfg, torch.Generator(dev).manual_seed(0),
                                device=dev)
    L = cfg.num_layers
    for opts, dec in (({}, "decode_attention"),
                      ({"kv_layout": "paged", "page_size": 16,
                        "kv_dtype": "int8"}, "decode_attention_paged_q8")):
        outs = {}
        for backend in (None, "ref"):
            reqs = [Request(uid=i, prompt=list(range(3, 3 + n)),
                            max_new_tokens=12)
                    for i, n in enumerate((5, 17, 1, 40))]
            eng = ServingEngine(cfg, params, max_batch=4, cache_len=64,
                                attn_backend=backend, device=dev, **opts)
            kops.reset_launches()
            sched = eng.scheduler()
            for r in reqs:
                sched.submit(r)
            sched.tick()                       # admits all four
            torch.cuda.set_sync_debug_mode("error")
            try:
                for _ in range(8):
                    sched.tick()
            finally:
                torch.cuda.set_sync_debug_mode(0)
            sched.run()
            got = {k: v for k, v in kops.launches().items() if v}
            # a ring prefills every request; pages skip the prefix hits
            prefills = sched.admissions - sched.prefix_hits \
                if sched._paged else len(reqs)
            want = {"flash_attention": L * prefills,
                    dec: L * sched.decode_steps} if backend is None else {}
            assert got == want, (backend, opts)
            outs[backend] = [r.output for r in reqs]
        assert outs[None] == outs["ref"], opts


def test_moe_train_cli_matches_ref(dev, tmp_path):
    """launch.train --arch granite-moe-3b-a800m (reduced): losses on the
    card (B9 forward and backward) equal a ``ref`` run's."""
    from repro_torch.launch import train
    kops.reset_launches()
    got = train.main(["--arch", "granite-moe-3b-a800m", "--steps", "2",
                      "--batch", "2", "--seq", "64", "--publish",
                      str(tmp_path)])
    assert kops.launches()["flash_attention_dq"] == 2 * 2
    _, want = train.train("granite-moe-3b-a800m", steps=2, batch=2, seq=64,
                          device=dev, backend="ref")
    np.testing.assert_allclose(got, want, rtol=1e-4)


# ---------------------------------------------------------------------------
# The encoder-decoder (Whisper): 'bskd' decode at its shapes, the reduced
# model served and trained on the kernels against ``ref``
# ---------------------------------------------------------------------------

# (slots, valid lengths, paged, dtype): the decoder's self-attention ring
# of 448 slots (Whisper's decoder context) as a ring and as 16-slot pages,
# and the cross-attention over 1500 encoder frames, every lane's valid
# length the encoder's
WHISPER_DECODE = [(448, [1, 448, 65, 300, 64, 129, 447, 2], False, dt)
                  for dt in (torch.float32, torch.bfloat16, torch.int8)] + \
    [(448, [1, 448, 65, 300, 64, 129, 447, 2], True, dt)
     for dt in (torch.float32, torch.int8)] + \
    [(1500, [1500] * 8, False, dt) for dt in (torch.float32, torch.bfloat16)]


@pytest.mark.parametrize("s,valid,paged,dtype", WHISPER_DECODE)
def test_encdec_bskd_decode_at_whisper_shapes(dev, s, valid, paged, dtype):
    """B6/B7 on layer views of (L, B, S, 16, 64) 'bskd' caches (or (L, P,
    16, 16, 64) pools), 8 lanes, against the plain versions."""
    b, kvh, d, ps, L = 8, 16, 64, 16, 3
    q = randn(dev, b, kvh, d)
    vl = torch.tensor(valid, dtype=torch.int32, device=dev)
    w = s // ps
    outer = 1 + b * w if paged else b
    shape = (L, outer, ps, kvh, d) if paged else (L, outer, s, kvh, d)
    k, v = _cache(dev, shape, dtype, 1)[1], _cache(dev, shape, dtype, 2)[1]
    sc = None
    if dtype == torch.int8:
        sc = (_scales(dev, shape[:4], 3)[1], _scales(dev, shape[:4], 4)[1])
    if paged:
        pt = np.random.default_rng(2).permutation(np.arange(1, outer)) \
            .reshape(b, w).astype(np.int32)
        for i, n in enumerate(valid):
            pt[i, -(-n // ps):] = 0
        pt = torch.from_numpy(pt).to(dev)
        if sc is None:
            got = kops.decode_attention_paged(q, k, v, pt, vl, layout="bskd")
            want = ref.decode_attention_paged_ref(q, k, v, pt, vl,
                                                  layout="bskd")
        else:
            got = kops.decode_attention_paged_q8(q, k, v, *sc, pt, vl,
                                                 layout="bskd")
            want = ref.decode_attention_paged_q8_ref(q, k, v, *sc, pt, vl,
                                                     layout="bskd")
    elif sc is None:
        got = kops.decode_attention(q, k, v, vl, layout="bskd")
        want = ref.decode_attention_ref(q, k, v, vl, layout="bskd")
    else:
        got = kops.decode_attention_q8(q, k, v, *sc, vl, layout="bskd")
        want = ref.decode_attention_q8_ref(q, k, v, *sc, vl, layout="bskd")
    close(got, want, **DECODE_TOL)


def test_encdec_served_on_the_kernels_equals_ref(dev):
    """Reduced Whisper (2 + 2 layers, 8/8 heads of 32, 64 frames) through
    ServingEngine in the ring fp32 and paged int8 forms: greedy tokens on
    the kernels equal ``ref``'s; B8 launches (encoder + decoder self +
    cross layers) x prefills, B6 (cross) num_layers x decode steps and
    the self-attention's B6/B7 num_layers x decode steps, none on
    ``ref``; 8 ticks run under sync debug mode "error"."""
    from repro_torch import models
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.serving.engine import Request, ServingEngine
    cfg = reduced(get_config("whisper-medium"))
    params = models.init_params(cfg, torch.Generator(dev).manual_seed(0),
                                device=dev)
    L, E = cfg.num_layers, cfg.encoder_layers
    for opts, dec in (({}, "decode_attention"),
                      ({"kv_layout": "paged", "page_size": 16,
                        "kv_dtype": "int8"}, "decode_attention_paged_q8")):
        outs = {}
        for backend in (None, "ref"):
            reqs = [Request(uid=i, prompt=list(range(3, 3 + n)),
                            max_new_tokens=12)
                    for i, n in enumerate((5, 17, 1, 40))]
            eng = ServingEngine(cfg, params, max_batch=4, cache_len=64,
                                attn_backend=backend, device=dev, **opts)
            kops.reset_launches()
            sched = eng.scheduler()
            for r in reqs:
                sched.submit(r)
            sched.tick()                       # admits all four
            torch.cuda.set_sync_debug_mode("error")
            try:
                for _ in range(8):
                    sched.tick()
            finally:
                torch.cuda.set_sync_debug_mode(0)
            sched.run()
            got = {k: v for k, v in kops.launches().items() if v}
            steps = sched.decode_steps
            want = {"flash_attention": (E + 2 * L) * len(reqs),
                    "decode_attention": L * steps}
            want[dec] = want.get(dec, 0) + L * steps
            assert got == (want if backend is None else {}), (backend, opts)
            outs[backend] = [r.output for r in reqs]
        assert outs[None] == outs["ref"], opts


def test_encdec_train_cli_matches_ref(dev, tmp_path):
    """launch.train --arch whisper-medium (reduced, zero frames): losses
    on the card (B9 in the encoder, the decoder's self and cross
    attention) equal a ``ref`` run's."""
    from repro_torch.launch import train
    kops.reset_launches()
    got = train.main(["--arch", "whisper-medium", "--steps", "2",
                      "--batch", "2", "--seq", "64", "--publish",
                      str(tmp_path)])
    # two steps x (2 encoder + 2 x 2 decoder attentions)
    assert kops.launches()["flash_attention_dq"] == 2 * (2 + 2 * 2)
    _, want = train.train("whisper-medium", steps=2, batch=2, seq=64,
                          device=dev, backend="ref")
    np.testing.assert_allclose(got, want, rtol=1e-4)


# ---------------------------------------------------------------------------
# CUDA graphs, the twin of jax.jit: Graph.jit_apply behind InferenceEngine
# and the dense family's decode step, each against the same code run
# eagerly under disable_graphs(): outputs and tokens bit-equal (the same
# kernels in the same order), launch counts and counters equal.
# ---------------------------------------------------------------------------


def _cnn_store(tmp_path, name):
    from repro_torch.configs import get_config
    from repro_torch.core.importer import to_caffe_json
    from repro_torch.core.modelstore import ModelStore
    from repro_torch.models import cnn
    g = cnn.graph_for(get_config(name))
    params = g.init_params(torch.Generator().manual_seed(0))
    store = ModelStore(tmp_path)
    store.publish(name, to_caffe_json(g, params)[0], params)
    return g, store


@pytest.mark.parametrize("name", ["nin-cifar10", "lenet-mnist"])
def test_jit_apply_graphs_equal_eager(dev, tmp_path, name):
    """Per batch: a capture, then replays, bit-equal to the eager forwards
    with the same launches; three commands in flight each keep their own
    output; one graph per batch shape."""
    from repro_torch.core.engine import InferenceEngine
    from repro_torch.core.jit import disable_graphs
    g, store = _cnn_store(tmp_path, name)
    engine = InferenceEngine(store)
    rng = np.random.default_rng(0)
    for n, batch in enumerate((1, 8), 1):
        xs = [rng.standard_normal((batch, *g.input_shape))
              .astype(np.float32) for _ in range(3)]
        with disable_graphs():
            kops.reset_launches()
            eager = [engine.predict(name, x) for x in xs]
            want = kops.launches()
        kops.reset_launches()
        got = [engine.predict(name, x) for x in xs]
        assert kops.launches() == want
        assert all(torch.equal(a, b) for a, b in zip(got, eager))
        cbs = [engine.enqueue(name, x) for x in xs]
        flight = [cb.wait_until_completed() for cb in cbs]
        engine.fence()
        assert all(torch.equal(a, b) for a, b in zip(flight, eager))
        assert len({t.data_ptr() for t in flight}) == 3
        assert len(engine.load(name)[3]._graphs) == n


def test_jit_apply_after_evict_and_reload(dev, tmp_path):
    """An evicted model's graphs go with its weights; reloaded (new
    tensors), it captures anew and answers as before."""
    from repro_torch.core.engine import InferenceEngine
    g, store = _cnn_store(tmp_path, "nin-cifar10")
    rec = store.get("nin-cifar10")
    store.publish("other", rec.load_spec(), rec.load_params())
    engine = InferenceEngine(store, max_resident=1)
    x = np.random.default_rng(1).standard_normal((8, *g.input_shape)) \
        .astype(np.float32)
    want = engine.predict("nin-cifar10", x)
    assert torch.equal(engine.predict("nin-cifar10", x), want)
    fn = engine.load("nin-cifar10")[3]
    assert len(fn._graphs) == 1
    engine.predict("other", x)
    assert fn._graphs == {}
    junk = [torch.full((1 << 20,), float("nan"), device=dev)
            for _ in range(8)]           # over the freed weights, if reused
    assert torch.equal(engine.predict("nin-cifar10", x), want)
    assert torch.equal(engine.predict("nin-cifar10", x), want)
    assert len(fn._graphs) == 1
    del junk


# id -> (paged int8, layout, KV heads, G, head dim, capacity): TinyLlama's
# heads on the FFMA route; RecurrentGemma-9B's (G 16, D 256) on the wide
# route, whose merge kernel takes no tickets, over its 2048-slot window;
# Whisper-medium's cross-attention over 1500 'bskd' encoder slots, every
# lane's valid length the encoder's (its splits merged through tickets)
REPLAY_CASES = {"ring-fp32": (False, "bksd", 4, 8, 64, 1024),
                "paged-int8": (True, "bksd", 4, 8, 64, 1024),
                "wide-ring-fp32": (False, "bksd", 1, 16, 256, 2048),
                "wide-paged-int8": (True, "bksd", 1, 16, 256, 2048),
                "cross-bskd-1500": (False, "bskd", 16, 1, 64, 1500)}


def _replay_inputs(dev, paged, layout, kvh, g, d, cap, b=8):
    q = randn(dev, b, kvh * g, d)
    if not paged:
        shape = (b, kvh, cap, d) if layout == "bksd" else (b, cap, kvh, d)
        return q, (randn(dev, *shape, seed=1), randn(dev, *shape, seed=2))
    ps, w = 16, cap // 16
    pages = 1 + b * w
    k = torch.randint(-127, 128, (pages, kvh, ps, d), dtype=torch.int8,
                      generator=torch.Generator().manual_seed(1)).to(dev)
    v = torch.randint(-127, 128, (pages, kvh, ps, d), dtype=torch.int8,
                      generator=torch.Generator().manual_seed(2)).to(dev)
    ks = randn(dev, pages, kvh, ps, seed=3).abs() / 127
    vs = randn(dev, pages, kvh, ps, seed=4).abs() / 127
    table = (torch.randperm(pages - 1, generator=torch.Generator()
                            .manual_seed(5)) + 1).reshape(b, w)
    return q, (k, v, ks, vs, table.to(torch.int32).to(dev))


@pytest.mark.parametrize("case", list(REPLAY_CASES))
def test_decode_kernel_replays_bit_equal_and_leaves_counters_at_zero(dev,
                                                                     case):
    """B6 / B7 captured once: 20 replays over new queries and, but for
    the cross-attention, new valid lengths (lane 0 at the whole capacity:
    a wrapped ring) each equal an eager launch bit for bit, and every
    workspace's ticket counters are 0 after them (the last CTA resets
    them; the wide route takes none; a replay has no memset)."""
    from repro_torch.core.jit import capture
    from repro_torch.kernels import decode_attention as da
    paged, layout, kvh, g, d, cap = REPLAY_CASES[case]
    q, cache = _replay_inputs(dev, paged, layout, kvh, g, d, cap)
    assert da.plan(8, kvh, g, d, 4, slots=cap).wide == (g == 16)
    valid = torch.full((8,), cap, dtype=torch.int32, device=dev)
    fn = kops.decode_attention_paged_q8 if paged else kops.decode_attention

    def call():
        return fn(q, *cache, valid, layout=layout)
    first, cap_graph = capture(call, dev)
    assert torch.equal(first, call())
    gen = torch.Generator().manual_seed(6)
    for _ in range(20):
        q.copy_(torch.randn(q.shape, generator=gen))
        if case != "cross-bskd-1500":
            valid.copy_(torch.randint(1, cap + 1, (8,), generator=gen))
            valid[0] = cap
        got = cap_graph.replay().clone()
        assert torch.equal(got, call())
    torch.cuda.synchronize()
    for key, ws in da._WORKSPACES.items():
        lanes = key[2] * key[3]
        assert int(ws[:lanes].abs().sum()) == 0, key


# (reduced arch, cache form): every family whose step is captured, in the
# cache forms it serves (RWKV-6 keeps its state, no pages)
GRAPH_FORMS = {"ring-fp32": {}, "paged-int8": {"kv_layout": "paged",
                                               "page_size": 16,
                                               "kv_dtype": "int8"}}
GRAPH_CASES = [(a, f) for a in ("tinyllama-1.1b", "whisper-medium",
                                "recurrentgemma-9b", "granite-moe-3b-a800m")
               for f in GRAPH_FORMS] + [("rwkv6-3b", "ring-fp32")]


@pytest.mark.parametrize("arch,form", GRAPH_CASES)
def test_scheduler_graph_equals_eager(dev, arch, form):
    """A reduced model through ServingEngine, 5 requests on 4 lanes
    (mid-flight admission; prefix hits on TinyLlama's pages; a prompt
    past RecurrentGemma's window of 32), two lanes at temperature > 0:
    the step captured once and replayed gives the eager step's tokens
    from the same seed, decode_steps, host_syncs and launches; 8
    replayed ticks run under sync debug mode "error"."""
    from contextlib import nullcontext

    from repro_torch import models
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.core.jit import disable_graphs
    from repro_torch.serving.engine import Request, ServingEngine
    cfg = reduced(get_config(arch))
    params = models.init_params(cfg, torch.Generator(dev).manual_seed(0),
                                device=dev)
    opts = GRAPH_FORMS[form]

    def run(eager):
        reqs = [Request(uid=i, prompt=list(range(3, 3 + n)),
                        max_new_tokens=12, temperature=t)
                for i, (n, t) in enumerate(((5, 0.0), (17, 0.8), (1, 0.0),
                                            (40, 1.3), (9, 0.0)))]
        eng = ServingEngine(cfg, params, max_batch=4, cache_len=64,
                            seed=3, device=dev, **opts)
        with disable_graphs() if eager else nullcontext():
            kops.reset_launches()
            sched = eng.scheduler()
            for r in reqs:
                sched.submit(r)
            sched.tick()                       # admits four, captures
            torch.cuda.set_sync_debug_mode("error")
            try:
                for _ in range(8):
                    sched.tick()
            finally:
                torch.cuda.set_sync_debug_mode(0)
            sched.run()
            launches = {k: v for k, v in kops.launches().items() if v}
        return ([r.output for r in reqs], sched.decode_steps,
                sched.host_syncs, launches, sched._graph is not None)
    graph, eager = run(False), run(True)
    assert graph[:4] == eager[:4]
    assert graph[4] and not eager[4]
    want = {"rwkv6_chunked"} if arch == "rwkv6-3b" else {
        "flash_attention", "decode_attention_paged_q8" if opts
        else "decode_attention"}
    assert want <= set(graph[3])


# (prompt length, temperature) of the bucketed runs: the two of 20 share
# 19 tokens in bucket 32, a whole page (a prefix hit on the paged dense
# and MoE schedulers); 40 is past the top bucket (admitted eagerly); 5
# and 7 share bucket 8 (a replay)
BUCKETS = [8, 16, 32]
BUCKET_PROMPTS = ((5, 0.0), (20, 0.8), (20, 0.0), (40, 1.3), (9, 0.0),
                  (7, 0.0))


@pytest.mark.parametrize("arch,form", GRAPH_CASES)
def test_bucketed_scheduler_graphs_equal_eager(dev, arch, form):
    """The runs of test_scheduler_graph_equals_eager with prefill buckets
    8, 16, 32: admission is captured once per bucket it meets and
    replayed (the 40-token prompt past the top bucket is admitted
    eagerly), the paged dense and MoE schedulers' prefix hit runs the
    captured suffix step and closing sample; tokens (sampled ones
    included), decode_steps, host_syncs and launches equal the eager
    run's under disable_graphs(), which captures nothing."""
    from contextlib import nullcontext

    from repro_torch import models
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.core.jit import disable_graphs
    from repro_torch.serving.engine import Request, ServingEngine
    cfg = reduced(get_config(arch))
    params = models.init_params(cfg, torch.Generator(dev).manual_seed(0),
                                device=dev)
    opts = GRAPH_FORMS[form]

    def run(eager):
        reqs = [Request(uid=i, prompt=list(range(3, 3 + n)),
                        max_new_tokens=12, temperature=t)
                for i, (n, t) in enumerate(BUCKET_PROMPTS)]
        reqs[2].prompt[-1] = 99
        eng = ServingEngine(cfg, params, max_batch=4, cache_len=64,
                            seed=3, prefill_buckets=BUCKETS, device=dev,
                            **opts)
        with disable_graphs() if eager else nullcontext():
            kops.reset_launches()
            sched = eng.scheduler()
            for r in reqs:
                sched.submit(r)
            sched.run()
            launches = {k: v for k, v in kops.launches().items() if v}
        replays = {k: g.replays for k, g in sched._graphs.items()}
        return ([r.output for r in reqs], sched.decode_steps,
                sched.host_syncs, launches, replays, sched.prefix_hits)
    graph, eager = run(False), run(True)
    assert graph[:4] == eager[:4] and graph[5] == eager[5]
    assert eager[4] == {}
    assert {("admit", 8), ("admit", 16), ("admit", 32)} <= set(graph[4])
    assert ("admit", 40) not in graph[4]
    assert graph[4][("admit", 8)] >= 1
    if graph[5]:                                # a prefix hit
        assert graph[4]["suffix"] >= 1 and "finalize" in graph[4]
    assert graph[5] == (arch in ("tinyllama-1.1b", "granite-moe-3b-a800m")
                        and form == "paged-int8")


def test_rebuilt_scheduler_captures_its_own_graph(dev):
    """A request that needs a larger output buffer rebuilds the engine's
    scheduler (a new cache): the new scheduler captures a graph of its
    own, and its tokens equal an eager run's."""
    from repro_torch import models
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.core.jit import disable_graphs
    from repro_torch.serving.engine import Request, ServingEngine
    cfg = reduced(get_config("tinyllama-1.1b"))
    params = models.init_params(cfg, torch.Generator(dev).manual_seed(1),
                                device=dev)

    def serve(eng, new):
        reqs = [Request(uid=i, prompt=list(range(5 + i, 12 + 2 * i)),
                        max_new_tokens=new) for i in range(3)]
        eng.generate_batch(reqs)
        return [r.output for r in reqs]
    eng = ServingEngine(cfg, params, max_batch=2, cache_len=96, device=dev)
    small = serve(eng, 8)
    first = eng.scheduler()._graph
    large = serve(eng, 40)                      # max_new_cap 16 -> 64
    second = eng.scheduler()._graph
    assert first is not None and second is not None and second is not first
    with disable_graphs():
        eager = ServingEngine(cfg, params, max_batch=2, cache_len=96,
                              device=dev)
        assert serve(eager, 8) == small and serve(eager, 40) == large
