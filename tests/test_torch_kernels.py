"""Kernel parity: the port's wrappers against the JAX package's Pallas
kernels (interpret mode on the CPU), on the same numpy inputs.

On the CPU each wrapper runs its plain version, so these hold the
port's arithmetic, shapes, padding and layouts against the reference;
the CUDA kernels themselves are held against the plain versions on the
card (tests/test_torch_cuda.py and chip_smoke.py).  Also the port's
rules: no jax or repro import, nothing built at import time, no
fallback to a plain version for a tensor that is not on the CPU.
"""
import ast
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import _build
from repro_torch.kernels import ops as tops

from conftest import assert_close

REPO = pathlib.Path(__file__).resolve().parents[1]
RNG_SEED = 1234


def rand(*shape, seed=0, scale=1.0):
    rng = np.random.default_rng(RNG_SEED + seed)
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# B1 matmul: every epilogue, ragged shapes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("act", ["none", "relu", "silu", "gelu"])
@pytest.mark.parametrize("m,k,n", [(37, 75, 19), (130, 200, 70)])
def test_matmul_epilogues_match_pallas(m, k, n, act):
    a, b, bias = rand(m, k), rand(k, n, seed=1), rand(n, seed=2)
    want = jops.matmul(jnp.asarray(a), jnp.asarray(b), jnp.asarray(bias),
                       activation=act)
    got = tops.matmul(t(a), t(b), t(bias), activation=act)
    assert_close(got, want, rtol=1e-4)


def test_matmul_no_bias_and_strided_b_match_pallas():
    a, w = rand(33, 40), rand(21, 40, seed=1)       # b = w.T, a strided view
    want = jops.matmul(jnp.asarray(a), jnp.asarray(w).T)
    got = tops.matmul(t(a), t(w).t())
    assert_close(got, want, rtol=1e-4)


def test_gelu_is_the_tanh_form():
    """jax.nn.gelu defaults to the tanh approximation; torch's F.gelu to
    erf.  The port follows JAX."""
    x = rand(4096, seed=3, scale=3.0)
    got = tops.elementwise(t(x), "gelu")
    tanh_form = torch.nn.functional.gelu(t(x), approximate="tanh")
    erf_form = torch.nn.functional.gelu(t(x))
    assert_close(got, tanh_form, rtol=1e-5, atol=1e-6)
    assert float((got - erf_form).abs().max()) > 1e-4


# ---------------------------------------------------------------------------
# B2 conv2d: im2col + B1
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cin,cout,k,stride,pad,hw", [
    (3, 16, 5, 1, 2, 12),    # k5/p2 (NIN conv1)
    (8, 8, 3, 1, 1, 10),     # k3/p1 (NIN block 3)
    (16, 8, 1, 1, 0, 9),     # 1x1 mlpconv
    (8, 16, 3, 2, 0, 11),    # stride 2
    (1, 4, 5, 1, 0, 14),     # LeNet-style
])
def test_conv2d_matches_pallas(cin, cout, k, stride, pad, hw):
    x = rand(2, cin, hw, hw)
    w = rand(cout, cin, k, k, seed=1, scale=0.2)
    b = rand(cout, seed=2)
    want = jops.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                       stride=stride, pad=pad)
    got = tops.conv2d(t(x), t(w), t(b), stride=stride, pad=pad)
    assert got.is_contiguous()
    assert_close(got, want, rtol=1e-3)


# ---------------------------------------------------------------------------
# B3 pool2d: max / avg, pad 0/1, k 2/3/8, stride 1/2, ragged H
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["max", "avg"])
@pytest.mark.parametrize("k,s,p,h", [
    (2, 2, 0, 12),   # LeNet
    (3, 2, 1, 16),   # NIN pool 1/2
    (8, 1, 0, 8),    # NIN global average
    (3, 1, 1, 7),
    (3, 2, 0, 9),    # H not divisible by the stride
    (2, 2, 1, 11),
])
def test_pool2d_matches_pallas(mode, k, s, p, h):
    x = rand(2, 3, h, h + 1)
    want = jops.pool2d(jnp.asarray(x), mode=mode, kernel=k, stride=s, pad=p)
    got = tops.pool2d(t(x), mode=mode, kernel=k, stride=s, pad=p)
    assert tuple(got.shape) == tuple(want.shape)
    assert_close(got, want, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# B4 elementwise / B5 softmax
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("act", ["relu", "silu", "gelu", "tanh", "sigmoid"])
def test_elementwise_matches_pallas(act):
    x = rand(3, 7, 61, scale=4.0)                   # not a multiple of 128
    want = jops.elementwise(jnp.asarray(x), act)
    got = tops.elementwise(t(x), act)
    assert_close(got, want, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("r,n,scale", [(8, 10, 1.0), (13, 200, 5.0),
                                       (4, 33, 1e4)])
def test_softmax_matches_pallas(r, n, scale):
    x = rand(r, n, scale=scale)
    x[0, 0], x[-1, -1] = 1e4, -1e4                  # extreme values
    want = jops.softmax(jnp.asarray(x))
    got = tops.softmax(t(x))
    assert_close(got, want, rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(got.sum(-1).numpy(), np.ones(r), rtol=1e-5)


# ---------------------------------------------------------------------------
# Rules of the port
# ---------------------------------------------------------------------------


def _port_sources():
    return sorted((REPO / "src" / "repro_torch").rglob("*.py")) + \
        [REPO / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_repro():
    sources = _port_sources()
    assert len(sources) > 15
    bad = [(p.relative_to(REPO).as_posix(), m) for p in sources
           for m in _imported_modules(p)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad


def test_importing_the_kernels_builds_nothing():
    import repro_torch.core.engine  # noqa: F401  imports every wrapper
    import repro_torch.serving.engine  # noqa: F401  and the serving path
    assert _build._library is None and _build.build_seconds is None
    assert set(tops.KERNELS) == {
        "matmul", "conv2d", "pool2d", "elementwise", "softmax",
        "decode_attention",
        "decode_attention_q8", "decode_attention_paged",
        "decode_attention_paged_q8"}


def test_cpu_tensors_take_the_plain_version_without_counting():
    tops.reset_launches()
    x = t(rand(2, 4, 8, 8))
    tops.relu(tops.pool2d(x))
    tops.softmax(tops.matmul(x.reshape(2, -1), t(rand(256, 5))))
    assert tops.launches() == {k: 0 for k in tops.KERNELS}


@pytest.mark.parametrize("call", [
    lambda x: tops.relu(x),
    lambda x: tops.pool2d(x.reshape(1, 1, 4, 4)),
    lambda x: tops.softmax(x.reshape(2, 8)),
    lambda x: tops.matmul(x.reshape(4, 4), x.reshape(4, 4)),
])
def test_non_cpu_tensor_never_falls_back(call):
    """A tensor that is not on the CPU launches the kernel or raises: a
    meta tensor is neither CPU nor CUDA, so the wrapper must raise."""
    with pytest.raises(ValueError, match="CUDA device"):
        call(torch.empty(16, device="meta"))
