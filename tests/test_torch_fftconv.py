"""FFT convolution, compression and the registry's extension point: the
port's ``core/fftconv.py``, ``core/compress.py``, ``register_backend``,
``quantization_error`` / ``QTensor.shape`` and the CNN ``loss_fn``
against the JAX package's, on the same numpy inputs.

FFT convolutions are held at 1e-4 (both packages transform in complex64
and differ in the FFT's summation order); NIN through the ``fft`` conv
route is held to ``ref`` at the CNN bars (rtol 1e-3, atol 1e-4).  The
compression stages give the JAX package's rank, kept indices and byte
counts exactly, and its errors at 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.core import compress as jcompress
from repro.core import fftconv as jfft
from repro.core import quantize as jquantize
from repro.core.ops import REGISTRY as JREGISTRY
from repro.models import cnn as jcnn
from repro_torch.configs import get_config
from repro_torch.core import compress, fftconv, quantize
from repro_torch.core.ops import ApplyContext, REGISTRY
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import conv2d_ref
from repro_torch.models import cnn

from test_torch_graph import numpy_params
from test_torch_transformer import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-4)
CNN_TOL = dict(rtol=1e-3, atol=1e-4)


def t(a):
    return torch.from_numpy(np.array(a))


def rand(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (scale * rng.standard_normal(shape)).astype(np.float32)


# ---------------------------------------------------------------------------
# FFT convolution (roadmap item 1)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("k,pad", [(3, 1), (5, 2), (7, 3), (3, 0)])
def test_fft_conv_matches_jax_and_direct(k, pad, stride):
    """fft_conv2d against the JAX function and against the port's direct
    conv2d_ref, with and without a bias."""
    x = rand((2, 4, 16, 13), k)
    w = rand((8, 4, k, k), k + 1, 0.2)
    b = rand((8,), k + 2)
    for bias in (None, b):
        got = fftconv.fft_conv2d(t(x), t(w), None if bias is None
                                 else t(bias), stride=stride, pad=pad)
        want = jfft.fft_conv2d(jnp.asarray(x), jnp.asarray(w),
                               None if bias is None else jnp.asarray(bias),
                               stride=stride, pad=pad)
        direct = conv2d_ref(t(x), t(w), None if bias is None else t(bias),
                            stride=stride, pad=pad)
        assert got.dtype == torch.float32 and got.shape == direct.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        np.testing.assert_allclose(got.numpy(), direct.numpy(), **TOL)


def test_fft_shape_and_flops_equal_jax():
    for h, w, k in ((16, 16, 3), (20, 20, 5), (32, 7, 7), (1, 1, 1)):
        assert fftconv._fft_shape(h, w, k) == jfft._fft_shape(h, w, k)
    for h, c, o, k in ((32, 64, 64, 7), (8, 64, 64, 1), (13, 3, 192, 5)):
        assert fftconv.fft_conv_flops(h, h, c, o, k) == \
            jfft.fft_conv_flops(h, h, c, o, k)
    direct = lambda h, c, o, k: 2 * h * h * c * o * k * k
    assert fftconv.fft_conv_flops(32, 32, 64, 64, 7) < direct(32, 64, 64, 7)
    assert fftconv.fft_conv_flops(8, 8, 64, 64, 1) > direct(8, 64, 64, 1)


def test_precomputed_filters_match_jax_and_are_reused():
    """The filter transform equals JAX's (complex64), and one precomputed
    transform serves several inputs."""
    w = rand((8, 4, 5, 5), 3, 0.2)
    pre = fftconv.precompute_filters(t(w), (32, 32))
    jpre = jfft.precompute_filters(jnp.asarray(w), (32, 32))
    assert pre.dtype == torch.complex64 and tuple(pre.shape) == jpre.shape
    np.testing.assert_allclose(pre.numpy(), np.asarray(jpre), **TOL)
    for i in range(2):
        x = rand((1, 4, 16, 16), 10 + i)
        got = fftconv.fft_conv2d(t(x), t(w), pad=2, w_fft=pre)
        want = conv2d_ref(t(x), t(w), None, stride=1, pad=2)
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_nin_on_the_fft_conv_route_matches_ref_and_jax():
    """NIN-CIFAR10 at full width, batch 2, with every conv on the ``fft``
    backend and the rest on ``cuda`` (the plain versions on the CPU),
    against ``ref`` and against the JAX graph on its own ``fft`` route;
    no kernel launches on CPU tensors."""
    graph = cnn.graph_for(get_config("nin-cifar10"))
    jgraph = jcnn.graph_for(jget_config("nin-cifar10"))
    np_params = numpy_params(graph)
    params = {l: {k: t(v) for k, v in g.items()}
              for l, g in np_params.items()}
    x = rand((2, *graph.input_shape), 1)
    kops.reset_launches()
    got = graph.apply(params, t(x), backend={"conv": "fft",
                                             "default": "cuda"})
    assert not any(kops.launches().values())
    want = graph.apply(params, t(x), backend="ref")
    np.testing.assert_allclose(got.numpy(), want.numpy(), **CNN_TOL)
    jgot = jgraph.apply(np_params, jnp.asarray(x), backend={"conv": "fft"})
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot), **CNN_TOL)
    spec = REGISTRY.op("conv")
    assert set(spec.backends) == {"ref", "cuda", "fft"}
    assert ("fft" in spec.backends) == ("fft" in JREGISTRY.op("conv").backends)


# ---------------------------------------------------------------------------
# Compression (roadmap items 7 and 8)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rank", [None, 16, 5])
def test_lowrank_matches_jax(rank):
    """The factors' product, the rank (picked by energy when None) and
    the approximate matmul against JAX's; an exactly rank-16 matrix is
    recovered."""
    a, b = rand((128, 16), 7), rand((16, 64), 8)
    w = a @ b + rand((128, 64), 9, 1e-3)
    lr = compress.lowrank(t(w), rank=rank)
    jlr = jcompress.lowrank(jnp.asarray(w), rank=rank)
    assert lr.shape == jlr.shape == (128, 64)
    assert lr.u.shape[1] == jlr.u.shape[1]
    np.testing.assert_allclose(lr.dense().numpy(), np.asarray(jlr.dense()),
                               **TOL)
    x = rand((4, 128), 10)
    np.testing.assert_allclose(lr.matmul(t(x)).numpy(),
                               np.asarray(jlr.matmul(jnp.asarray(x))),
                               rtol=1e-4, atol=1e-3)
    if rank == 16:
        assert compress.rel_error(t(w), lr.dense()) < 1e-3
    with pytest.raises(ValueError, match="2D"):
        compress.lowrank(t(w)[None])


@pytest.mark.parametrize("sparsity", [0.9, 0.5, 0.999])
def test_prune_matches_jax(sparsity):
    """The kept indices (sorted) and values equal JAX's exactly; the
    dense form has the asked sparsity."""
    w = rand((64, 48), 4)
    sp = compress.prune(t(w), sparsity)
    jsp = jcompress.prune(jnp.asarray(w), sparsity)
    assert sp.indices.dtype == torch.int32 and sp.shape == jsp.shape
    np.testing.assert_array_equal(sp.indices.numpy(), np.asarray(jsp.indices))
    np.testing.assert_array_equal(sp.values.numpy(), np.asarray(jsp.values))
    np.testing.assert_array_equal(sp.dense().numpy(), np.asarray(jsp.dense()))
    nnz = float((sp.dense() != 0).float().mean())
    assert abs(nnz - (1 - sparsity)) < 0.01


@pytest.mark.parametrize("rank,sparsity", [(64, 0.9), (8, 0.5)])
def test_compress_report_matches_jax(rank, sparsity):
    """Every stage's bytes, ratio and rank equal JAX's, the errors within
    1e-5; int8 and lowrank+int8 reach the ratios the JAX suite asks."""
    w = rand((512, 256), 5)
    rep = compress.compress_report(t(w), rank=rank, sparsity=sparsity)
    jrep = jcompress.compress_report(jnp.asarray(w), rank=rank,
                                     sparsity=sparsity)
    assert rep["fp32_bytes"] == jrep["fp32_bytes"]
    for stage in ("lowrank", "pruned", "int8", "lowrank+int8"):
        for key, want in jrep[stage].items():
            if key == "error":
                assert abs(rep[stage][key] - want) <= 1e-5, stage
            else:
                assert rep[stage][key] == want, (stage, key)
    assert rep["int8"]["ratio"] >= 3.9
    assert compress.rel_error(t(w), t(w)) == jcompress.rel_error(w, w) == 0.0


# ---------------------------------------------------------------------------
# the functions of modules marked done (A18)
# ---------------------------------------------------------------------------


def test_register_backend_is_the_named_extension_point():
    """A backend added through register_backend is resolved by name by
    Graph.apply, as in the JAX registry; an unknown kind raises."""
    calls = []

    def doubled_relu(x, p, a, ctx):
        calls.append(tuple(x.shape))
        return 2 * torch.relu(x)
    spec = REGISTRY.op("relu")
    try:
        REGISTRY.register_backend("relu", "doubled", doubled_relu)
        assert spec.backend("doubled") is doubled_relu
        out = spec.backend("doubled")(torch.tensor([-1.0, 3.0]), None, {},
                                      ApplyContext())
        assert out.tolist() == [0.0, 6.0] and calls == [(2,)]
    finally:
        spec.backends.pop("doubled", None)
    assert spec.backend("doubled") is spec.backends["ref"]
    with pytest.raises(KeyError, match="unknown op kind"):
        REGISTRY.register_backend("nope", "x", doubled_relu)
    with pytest.raises(KeyError):
        JREGISTRY.register_backend("nope", "x", doubled_relu)


@pytest.mark.parametrize("axis", [-1, 0])
def test_quantization_error_and_shape_match_jax(axis):
    w = rand((48, 40), 6)
    w[3] = 0.0                                   # an all-zero channel
    qt = quantize.quantize(t(w), axis=axis)
    jqt = jquantize.quantize(jnp.asarray(w), axis=axis)
    assert qt.shape == jqt.shape == (48, 40)
    assert abs(quantize.quantization_error(t(w), qt)
               - jquantize.quantization_error(jnp.asarray(w), jqt)) <= 1e-6
    zero = quantize.quantize(torch.zeros(4, 4))
    assert quantize.quantization_error(torch.zeros(4, 4), zero) == 0.0


@pytest.mark.parametrize("name", ["nin-cifar10", "lenet-mnist"])
def test_cnn_loss_fn_and_param_template_match_jax(name):
    """The clipped-log NLL over forward against JAX's on the same weights
    and labels; param_template raises in both packages."""
    graph = cnn.graph_for(get_config(name))
    np_params = numpy_params(graph, seed=2)
    params = {l: {k: t(v) for k, v in g.items()}
              for l, g in np_params.items()}
    x = rand((3, *graph.input_shape), 2)
    labels = np.asarray([0, 3, 9], np.int32)
    loss, aux = cnn.loss_fn(get_config(name), params,
                            {"images": t(x), "labels": t(labels)},
                            backend="ref")
    jloss, _ = jcnn.loss_fn(jget_config(name), np_params,
                            {"images": jnp.asarray(x),
                             "labels": jnp.asarray(labels)})
    assert aux["loss"] is loss
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    for fn, cfg in ((cnn.param_template, get_config(name)),
                    (jcnn.param_template, jget_config(name))):
        with pytest.raises(NotImplementedError, match="init_params"):
            fn(cfg)
