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
import ctypes
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.kernels import ops as jops
from repro_torch.kernels import _build
from repro_torch.kernels import int8_matmul as ti8
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rwkv6_chunk as trwc

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


# LeNet's dense layers (800 -> 500 -> 10) at batch 1, 8 and 16
LENET_DENSE = [(m, k, n) for m in (1, 8, 16) for k, n in ((800, 500),
                                                         (500, 10))]


@pytest.mark.parametrize("m,k,n", LENET_DENSE + [(8, 803, 500), (16, 20000, 7),
                                                 (3, 2401, 65), (1, 3, 5)])
def test_matmul_plan_takes_split_k_for_skinny_products(m, k, n):
    """M <= 16 takes split-K: every K slice non-empty and at most
    MAX_SPAN deep; where K allows, the (strip, slice) CTAs fill one wave
    of the 132 SMs and stay within two; LeNet's 500 -> 10 layer gets at
    least 32 CTAs; the workspace is one M x N tile a slice."""
    from repro_torch.kernels import matmul as mm
    s = mm.plan(m, n, k, 132)
    span = -(-k // s)
    assert 1 <= s and (s - 1) * span < k <= s * span and span <= mm.MAX_SPAN
    ctas = -(-n // mm.SPLIT_COLS) * s
    if k // mm.MIN_SPAN * -(-n // mm.SPLIT_COLS) >= 132:
        assert 132 <= ctas <= 2 * 132 + -(-n // mm.SPLIT_COLS) or \
            span == mm.MAX_SPAN
    if (k, n) == (500, 10):
        assert ctas >= 32
    if (k, n) == (800, 500):
        assert (s, ctas) == (32, 256)
    assert mm.workspace_floats(m, n, s) == s * m * n


@pytest.mark.parametrize("m,k,n", [(17, 800, 500), (1024, 2400, 192),
                                   (2048, 4800, 192), (64, 800, 500),
                                   (8, 0, 5)])
def test_matmul_plan_takes_the_tiled_kernel_for_large_m(m, k, n):
    from repro_torch.kernels import matmul as mm
    assert mm.plan(m, n, k, 132) == 0
    assert mm.workspace_floats(m, n, 0) == 0


@pytest.mark.parametrize("m,k,n", LENET_DENSE)
def test_matmul_plain_version_matches_pallas_at_lenet_dense_shapes(m, k, n):
    """B1's plain version (the CPU route) against the Pallas kernel in
    interpret mode at the split-K shapes: relu inputs, He weights, as on
    LeNet's path."""
    a = np.maximum(rand(m, k, seed=7), 0)
    b = rand(k, n, seed=8, scale=float(np.sqrt(2 / k)))
    bias = rand(n, seed=9, scale=0.1)
    want = jops.matmul(jnp.asarray(a), jnp.asarray(b), jnp.asarray(bias),
                       activation="relu", interpret=True)
    got = tref.matmul_ref(t(a), t(b), t(bias), activation="relu")
    assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert torch.equal(tops.matmul(t(a), t(b), t(bias), activation="relu"),
                       got)


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
# B2 conv2d: on the CPU its plain version, im2col + B1's plain version
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


# every conv of NIN-CIFAR10 and LeNet-MNIST, (C, H = W, O, K, stride, pad)
NIN_LENET_CONVS = [(3, 32, 192, 5, 1, 2), (192, 32, 160, 1, 1, 0),
                   (160, 32, 96, 1, 1, 0), (96, 16, 192, 5, 1, 2),
                   (192, 16, 192, 1, 1, 0), (192, 8, 192, 3, 1, 1),
                   (192, 8, 192, 1, 1, 0), (192, 8, 10, 1, 1, 0),
                   (1, 28, 20, 5, 1, 0), (20, 12, 50, 5, 1, 0)]


@pytest.mark.parametrize("c,hw,o,k,stride,pad", NIN_LENET_CONVS)
def test_conv2d_plain_version_matches_pallas_at_the_models_shapes(
        c, hw, o, k, stride, pad):
    """B2's plain version (im2col in the kernel's depth order + matmul_ref,
    the kernel's CPU route) against the JAX conv2d in interpret mode, He
    weights on relu inputs as on the models' path."""
    x = np.maximum(rand(2, c, hw, hw, seed=3), 0)
    w = rand(o, c, k, k, seed=4, scale=float(np.sqrt(2 / (c * k * k))))
    b = rand(o, seed=5, scale=0.1)
    want = jops.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                       stride=stride, pad=pad, interpret=True)
    got = tref.conv2d_im2col_ref(t(x), t(w), t(b), stride=stride, pad=pad)
    assert got.is_contiguous()
    assert_close(got, want, rtol=1e-3, atol=1e-4)
    assert torch.equal(tops.conv2d(t(x), t(w), t(b), stride=stride, pad=pad),
                       got)


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


# the global pools: the window is the whole plane (NIN's 8 x 8), or its
# first 31 rows of a 33 x 31 plane; one output per plane, no padding
GLOBAL_POOLS = [((2, 3, 8, 8), 8, 1), ((2, 3, 13, 13), 13, 1),
                ((2, 3, 33, 31), 31, 31)]


@pytest.mark.parametrize("mode", ["max", "avg"])
@pytest.mark.parametrize("shape,k,s", GLOBAL_POOLS)
def test_global_pool2d_matches_pallas(mode, shape, k, s):
    x = rand(*shape, seed=3)
    want = jops.pool2d(jnp.asarray(x), mode=mode, kernel=k, stride=s, pad=0)
    got = tops.pool2d(t(x), mode=mode, kernel=k, stride=s, pad=0)
    assert tuple(got.shape) == tuple(want.shape) == (*shape[:2], 1, 1)
    assert_close(got, want, rtol=1e-5, atol=1e-6)


# (shape, kernel, stride, pad) of every pool on NIN's and LeNet's paths
PATH_POOLS = [((b, 96, 32, 32), 3, 2, 1) for b in (1, 8, 64)] + \
    [((b, 192, 16, 16), 3, 2, 1) for b in (1, 8, 64)] + \
    [((b, 10, 8, 8), 8, 1, 0) for b in (1, 8, 64)] + \
    [((8, 20, 24, 24), 2, 2, 0), ((8, 50, 8, 8), 2, 2, 0)]


def _window_tiles(p):
    """Every CTA's (planes, output rows, output columns) of a windowed
    plan, as csrc/pool.cu finds them from the CTA's index and block."""
    for cta in range(p.grid):
        cb, rb = cta % p.col_bands, cta // p.col_bands % p.row_bands
        p0 = cta // (p.col_bands * p.row_bands) * p.planes
        oh0, ow0 = rb * p.band_rows, cb * p.band_cols
        assert p0 < p.bc and oh0 < p.oh and ow0 < p.ow
        yield range(p0, min(p0 + p.planes, p.bc)), \
            range(oh0, min(oh0 + p.band_rows, p.oh)), \
            range(ow0, min(ow0 + p.band_cols, p.ow))


@pytest.mark.parametrize("mode", ["max", "avg"])
@pytest.mark.parametrize("shape,k,s,p", PATH_POOLS + [
    ((2, 5, 17, 16), 3, 2, 1), ((1, 2, 40, 300), 5, 3, 2),
    ((1, 1, 10, 130), 4, 1, 3), ((3, 1, 6, 5), 1, 1, 0),
    ((1, 1, 64, 64), 64, 1, 0), ((2, 3, 33, 31), 31, 31, 0),
    ((2, 100, 5, 5), 5, 1, 0), ((64, 100, 3, 3), 3, 1, 0),
    ((1, 1, 3, 3000), 3, 1, 1), ((300, 2, 4, 4), 2, 2, 0)])
def test_pool_plan_covers_every_output_once(mode, shape, k, s, p):
    """The launch plan at the path's shapes and ragged ones, on 132 SMs:
    the plane route exactly for one output a plane without padding (one
    warp a plane, the CTAs spread over the SMs), the windowed route's
    tiles covering each output once, one thread an output."""
    from repro_torch.kernels import pool
    plan = pool.plan(shape, mode, k, s, p, sms=132)
    b, c, h, w = shape
    oh, ow = (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1
    assert (plan.oh, plan.ow, plan.bc, plan.is_max) == \
        (oh, ow, b * c, int(mode == "max"))
    if oh == ow == 1 and p == 0:
        warps = plan.block // 32
        assert plan.block == 32 * warps and 1 <= warps <= pool.PLANE_WARPS
        assert plan.route == pool.ROUTE_PLANE
        assert plan.grid == -(-b * c // warps)
        assert plan.grid >= min(b * c, 132)
        chunk = plan.smem // (4 * warps)
        assert plan.smem == 0 if mode == "max" else \
            (chunk % 4 == 0 and 0 < chunk <= pool.PLANE_CHUNK)
        return
    assert plan.route == pool.ROUTE_WINDOW
    assert plan.block == plan.band_cols * plan.band_rows * plan.planes
    assert plan.block <= pool.TILE_OUTPUTS and plan.planes <= 64
    assert plan.smem == 0
    seen = np.zeros((b * c, oh, ow), np.int32)
    for planes, rows, cols in _window_tiles(plan):
        seen[planes.start:planes.stop, rows.start:rows.stop,
             cols.start:cols.stop] += 1
    assert (seen == 1).all()
    if (shape, k, s, p) in PATH_POOLS:      # NIN and LeNet spread out
        assert plan.grid >= 132 or plan.planes == 1


def test_pool_plan_is_cached_per_call_shape():
    from repro_torch.kernels import pool
    first = pool.cached_plan((3, 7, 16, 16), "avg", 3, 2, 1, 132)
    again = pool.cached_plan(torch.Size((3, 7, 16, 16)), "avg", 3, 2, 1, 132)
    assert again is first and again[0] is first[0]
    assert first[1] == ctypes.addressof(first[0])
    assert first[2] == (3, 7, 8, 8)
    assert pool._PLANS[((3, 7, 16, 16), "avg", 3, 2, 1)] is first
    other = pool.cached_plan((3, 7, 16, 16), "max", 3, 2, 1, 132)
    assert other is not first and other[0].is_max == 1


@pytest.mark.parametrize("shape,kw,msg", [
    ((2, 3, 8, 8), dict(mode="sum"), "unknown pool mode 'sum'"),
    ((3, 8, 8), {}, r"pool2d: expected \(B, C, H, W\), got \(3, 8, 8\)"),
    ((1, 1, 4, 4), dict(kernel=5, stride=1), "pool2d: window 5/1/0 on 4x4"),
    ((1, 1, 4, 4), dict(kernel=2, stride=0), "pool2d: window 2/0/0 on 4x4"),
    ((1, 1, 4, 4), dict(kernel=2, pad=-1), "pool2d: window 2/2/-1 on 4x4"),
])
def test_pool2d_refuses_bad_geometry_with_the_same_messages(shape, kw, msg):
    """The wrapper on a CPU tensor and the plan both raise the geometry
    errors before anything else."""
    from repro_torch.kernels import pool
    args = dict(dict(mode="max", kernel=2, stride=2, pad=0), **kw)
    with pytest.raises(ValueError, match=f"^{msg}$"):
        tops.pool2d(torch.zeros(shape), **args)
    with pytest.raises(ValueError, match=f"^{msg}$"):
        pool.plan(shape, args["mode"], args["kernel"], args["stride"],
                  args["pad"], sms=132)


# ---------------------------------------------------------------------------
# B4 elementwise / B5 softmax
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("act", ["relu", "silu", "gelu", "tanh", "sigmoid"])
def test_elementwise_matches_pallas(act):
    x = rand(3, 7, 61, scale=4.0)                   # not a multiple of 128
    want = jops.elementwise(jnp.asarray(x), act)
    got = tops.elementwise(t(x), act)
    assert_close(got, want, rtol=1e-4, atol=1e-6)


def test_relu_out_of_place_and_in_place_on_the_cpu():
    """``relu`` leaves its input alone; ``relu_`` writes into it and returns
    it; both give the Pallas kernel's values."""
    x = rand(5, 33, scale=3.0)
    want = jops.elementwise(jnp.asarray(x), "relu")
    xt = t(x)
    out = tops.relu(xt)
    assert torch.equal(xt, t(x)) and out.data_ptr() != xt.data_ptr()
    assert_close(out, want, rtol=0, atol=0)
    same = tops.relu_(xt)
    assert same is xt and torch.equal(xt, out)
    with pytest.raises(ValueError, match="unknown activation 'swish'"):
        tops.elementwise(xt, "swish")


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
# B11 int8 matmul: the JAX test shapes and ragged ones
# ---------------------------------------------------------------------------


def int8_operands(m, k, n, seed=0):
    rng = np.random.default_rng(RNG_SEED + seed)
    aq = rng.integers(-127, 128, (m, k)).astype(np.int8)
    bq = rng.integers(-127, 128, (k, n)).astype(np.int8)
    asc = (np.abs(rng.standard_normal(m)) + 0.01).astype(np.float32)
    bsc = (np.abs(rng.standard_normal(n)) + 0.01).astype(np.float32)
    return aq, bq, asc, bsc


@pytest.mark.parametrize("m,k,n", [(128, 128, 128), (64, 512, 256),
                                   (1, 1, 1), (37, 130, 75), (17, 1000, 3)])
def test_int8_matmul_matches_pallas(m, k, n):
    args = int8_operands(m, k, n, seed=m + k + n)
    want = jops.int8_matmul(*map(jnp.asarray, args), interpret=True)
    tops.reset_launches()
    got = tops.int8_matmul(*map(t, args))
    assert tops.launches()["int8_matmul"] == 0      # the plain version
    assert got.dtype == torch.float32
    assert_close(got, want, rtol=1e-5, atol=0)


def test_int8_matmul_accumulates_in_int32():
    """512 * 127 * 127 overflows int16 but not int32."""
    a = torch.full((8, 512), 127, dtype=torch.int8)
    ones = torch.ones(8)
    got = tops.int8_matmul(a, a.t().contiguous(), ones, ones)
    assert torch.equal(got, torch.full((8, 8), 512.0 * 127 * 127))


def test_int8_matmul_refuses_what_the_kernel_does_not_take():
    a, b, sa, sb = map(t, int8_operands(4, 8, 3))
    with pytest.raises(TypeError, match="int8"):
        tops.int8_matmul(a.float(), b, sa, sb)
    with pytest.raises(TypeError, match="float32"):
        tops.int8_matmul(a, b, sa.double(), sb)
    with pytest.raises(ValueError, match="scales"):
        tops.int8_matmul(a, b, sb, sa)
    with pytest.raises(ValueError, match="shapes"):
        tops.int8_matmul(a, b.t(), sa, sb)


@settings(max_examples=25, deadline=None)
@given(m=st.integers(1, 32), k=st.integers(1, 64), n=st.integers(1, 32),
       seed=st.integers(0, 2 ** 16))
def test_int8_matmul_exact_integers(m, k, n, seed):
    """With unit scales the result is the exact integer product (the
    property test_properties.py holds the Pallas kernel to)."""
    aq, bq, _, _ = int8_operands(m, k, n, seed=seed)
    got = tops.int8_matmul(t(aq), t(bq), torch.ones(m), torch.ones(n))
    want = aq.astype(np.int64) @ bq.astype(np.int64)
    np.testing.assert_array_equal(got.numpy().astype(np.int64), want)


@pytest.mark.parametrize("m,k,n,splits", [(8, 512, 256, 3), (37, 130, 75, 2),
                                          (8, 1536, 96, 6), (1, 1, 1, 4)])
def test_int8_split_k_emulation_matches_pallas(m, k, n, splits):
    """B11's split sum (int32 partials over whole 64-deep stages, added,
    then scaled once) against the Pallas kernel in interpret mode, and
    bit-equal to the unsplit plain version."""
    args = int8_operands(m, k, n, seed=m * k + n)
    want = jops.int8_matmul(*map(jnp.asarray, args), interpret=True)
    got = ti8.split_k_emulation(*map(t, args), splits)
    assert_close(got, want, rtol=1e-5, atol=0)
    assert torch.equal(got, tops.int8_matmul(*map(t, args)))


def test_int8_split_k_emulation_wraps_as_int32():
    """All-127 operands at K 133,144 (the largest exact K) split 7 ways:
    the exact integer; one k more wraps the same split or not."""
    k = 133_144
    a = torch.full((3, k), 127, dtype=torch.int8)
    b = torch.full((k, 16), 127, dtype=torch.int8)
    ones3, ones16 = torch.ones(3), torch.ones(16)
    got = ti8.split_k_emulation(a, b, ones3, ones16, 7)
    assert torch.equal(got, torch.full((3, 16), float(127 * 127 * k)))
    a1 = torch.full((3, k + 1), 127, dtype=torch.int8)
    b1 = torch.full((k + 1, 16), 127, dtype=torch.int8)
    assert torch.equal(ti8.split_k_emulation(a1, b1, ones3, ones16, 7),
                       tops.int8_matmul(a1, b1, ones3, ones16))


@pytest.mark.parametrize("m,n,k,tile,splits,grid", [
    (8, 1536, 1536, 0, 6, (24, 1, 6)),        # a decode batch: split K
    (300, 1536, 1536, 1, 1, (24, 5, 1)),      # a prompt: 120 tiles
    (2048, 512, 1536, 1, 1, (8, 32, 1)),
    (2048, 1536, 512, 1, 1, (24, 32, 1)),
    (16, 64, 64, 0, 1, (1, 1, 1)),            # one stage: nothing to split
    (17, 3, 1000, 1, 16, (1, 1, 16)),         # 16 stages, one a split
])
def test_int8_plan(m, n, k, tile, splits, grid):
    p = ti8.plan(m, n, k, 132)
    assert (p.tile, p.splits, p.grid) == (tile, splits, grid)
    assert (p.bm, p.bn) == ti8.TILES[tile]
    ktiles = -(-k // ti8.BK)
    assert (p.splits - 1) * p.per < ktiles <= p.splits * p.per  # none empty
    assert p.tiles == grid[0] * grid[1]
    assert p.tiles * p.splits >= 66 or p.splits == ktiles or ktiles == 1


def test_int8_plan_forced_splits_and_alignment_route():
    """The split count follows the SM count (24 tiles at M 8), rounded so
    that no split is empty, and never passes K's stages; then the
    16-byte routes by K, N and the bases' alignment."""
    assert ti8.plan(8, 1536, 1536, 96).splits == 4
    assert ti8.plan(8, 1536, 1536, 120).splits == 5          # 5 x 5 >= 24
    assert ti8.plan(8, 1536, 1536, 160).splits == 6          # 6 x 4 covers 24
    assert ti8.plan(8, 1536, 1536, 48).splits == 1           # half the card
    assert ti8.plan(8, 1536, 100, 132).splits == 2           # 2 stages
    buf = torch.zeros(4096, dtype=torch.int8)
    a, b = buf[:64 * 32].view(64, 32), buf[2048:2048 + 32 * 48].view(32, 48)
    assert ti8.vector_route(a, b) == 3
    assert ti8.vector_route(buf[1:1 + 64 * 32].view(64, 32), b) == 2
    assert ti8.vector_route(a, buf[2049:2049 + 32 * 48].view(32, 48)) == 1
    a130 = buf[:4 * 130].view(4, 130)
    assert ti8.vector_route(a130, buf[:130 * 3].view(130, 3)) == 0


@pytest.mark.parametrize("b,t,h,n,mb", [
    (1, 300, 40, 64, 32),     # the RWKV-6 3B prefill: 80 scan CTAs
    (8, 2048, 40, 64, 32),    # 8 prompts: 640 scan CTAs
    (1, 5, 8, 32, 16),        # the reduced config
    (4, 33, 40, 64, 32),
    (2, 16, 8, 32, 16),
])
def test_wkv_plan(b, t, h, n, mb):
    p = trwc.plan(b, t, h, n)
    nc = -(-t // 16)
    assert (p.mb, p.threads) == (mb, 8 * mb)
    assert p.grid == (n // mb, h, b) and p.prep_grid == (nc, h, b)
    assert p.record == trwc.record_bytes(n) and p.record % 16 == 0
    assert p.workspace == b * h * nc * p.record


def test_wkv_plan_forced_blocks_and_records():
    """The column block is the kernel's fixed N / 2 at both head sizes,
    whatever B and T; other head sizes raise; the records' sizes."""
    for n in trwc.HEAD_SIZES:
        for b, t in ((1, 1), (1, 300), (8, 2048)):
            p = trwc.plan(b, t, 40, n)
            assert p.mb == n // 2 and p.grid[0] == 2
    with pytest.raises(ValueError, match="head size"):
        trwc.plan(1, 16, 40, 16)
    with pytest.raises(ValueError, match="head size"):
        trwc.plan(1, 16, 40, 48)
    # sizeof(Rec<64>) and sizeof(Rec<32>) counted by hand: 2 x 16 x N fp32
    # decayed r and k, N fp32 decays, 16 x N fp64 att . v
    assert trwc.record_bytes(64) == 4096 + 4096 + 256 + 8192 == 16640
    assert trwc.record_bytes(32) == 2048 + 2048 + 128 + 4096 == 8320


def test_wkv_records_kept_up_to_the_cap():
    """Up to KEEP_BYTES the records' buffer is one buffer of KEEP_BYTES
    per (device, stream), made at the first call and never replaced (a
    captured launch holds its address), whatever a later call needs; a
    larger call gets a buffer of its own that is not kept."""
    dev, stream = torch.device("cpu"), -12345
    try:
        small = trwc._records(dev, stream, 1000)
        assert small.numel() == trwc.KEEP_BYTES
        assert trwc._records(dev, stream, 800) is small
        assert trwc._records(dev, stream, 5000) is small
        assert trwc._records(dev, stream, trwc.KEEP_BYTES) is small
        big = trwc._records(dev, stream, trwc.KEEP_BYTES + 1)
        assert big.numel() == trwc.KEEP_BYTES + 1
        assert trwc._kept[(dev.index, stream)] is small
        assert trwc._records(dev, stream, 1000) is small
    finally:
        trwc._kept.pop((dev.index, stream), None)



# ---------------------------------------------------------------------------
# Rules of the port
# ---------------------------------------------------------------------------


def _port_sources():
    return sorted((REPO / "src" / "repro_torch").rglob("*.py")) + \
        [REPO / "chip_smoke.py"] + \
        sorted((REPO / "examples").glob("*_torch.py"))


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
    names = {p.relative_to(REPO).as_posix() for p in sources}
    assert {"src/repro_torch/models/moe.py",
            "src/repro_torch/kernels/int8_matmul.py",
            "src/repro_torch/sharding_hints.py",
            "src/repro_torch/launch/compat.py",
            "src/repro_torch/launch/mesh.py",
            "src/repro_torch/launch/sharding.py",
            "src/repro_torch/launch/op_costs.py",
            "src/repro_torch/launch/dryrun.py",
            "examples/quickstart_torch.py",
            "examples/serve_batched_torch.py",
            "examples/train_publish_serve_torch.py",
            "examples/compress_models_torch.py"} <= names
    bad = [(p.relative_to(REPO).as_posix(), m) for p in sources
           for m in _imported_modules(p)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad


def test_importing_the_kernels_builds_nothing():
    import repro_torch.core.engine  # noqa: F401  imports every wrapper
    import repro_torch.serving.engine  # noqa: F401  and the serving path
    import repro_torch.launch.train  # noqa: F401  and the training path
    assert _build._library is None and _build.build_seconds is None
    assert set(tops.KERNELS) == {
        "matmul", "conv2d", "pool2d", "elementwise", "softmax",
        "decode_attention",
        "decode_attention_q8", "decode_attention_paged",
        "decode_attention_paged_q8", "flash_attention",
        "flash_attention_fwd", "flash_attention_dq", "flash_attention_dkv",
        "rwkv6_chunked", "int8_matmul"}


def test_cpu_tensors_take_the_plain_version_without_counting():
    tops.reset_launches()
    x = t(rand(2, 4, 8, 8))
    tops.relu(tops.pool2d(x))
    tops.softmax(tops.matmul(x.reshape(2, -1), t(rand(256, 5))))
    r = x.reshape(2, 8, 1, 32)
    tops.rwkv6_chunked(r, r, r, r.sigmoid(), r[0, 0])
    q = x.reshape(8, 64).to(torch.int8)
    tops.int8_matmul(q, q.t().contiguous(), x[0, 0, 0], x[0, 0, 0])
    assert tops.launches() == {k: 0 for k in tops.KERNELS}


@pytest.mark.parametrize("call", [
    lambda x: tops.relu(x),
    lambda x: tops.relu_(x),
    lambda x: tops.elementwise(x, "gelu"),
    lambda x: tops.pool2d(x.reshape(1, 1, 4, 4)),
    lambda x: tops.pool2d(x.reshape(1, 1, 4, 4), mode="avg", kernel=4),
    lambda x: tops.softmax(x.reshape(2, 8)),
    lambda x: tops.matmul(x.reshape(4, 4), x.reshape(4, 4)),
    lambda x: tops.rwkv6_chunked(*[x.reshape(1, 1, 1, 16)] * 4,
                                 torch.empty(1, 16)),
    lambda x: tops.int8_matmul(*[x.reshape(4, 4).to(torch.int8)] * 2,
                               x[:4], x[4:8]),
    lambda x: tops.conv2d(x.reshape(1, 1, 4, 4), x[:9].reshape(1, 1, 3, 3)),
])
def test_non_cpu_tensor_never_falls_back(call):
    """A tensor that is not on the CPU launches the kernel or raises: a
    meta tensor is neither CPU nor CUDA, so the wrapper must raise (B10,
    whose wrapper takes meta tensors for the memory count, where one
    meets a CPU tensor)."""
    with pytest.raises(ValueError, match="CUDA device"):
        call(torch.empty(16, device="meta"))
