"""Decode-attention parity: the port's B6/B7 wrappers (their plain
versions on the CPU) against the JAX package's Pallas kernels, run as
``tests/test_kernels.py`` and ``tests/test_paged.py`` run them
(``repro.kernels.ops`` uses interpret mode off a TPU); and the serving
half of ``models/common`` against the JAX functions.

Both sides compute in fp32 from the same numpy inputs, so the kernels
agree within rtol 1e-5 and the int8 payloads and scales of the
quantizing writes are bit-equal.  The CUDA kernels themselves are held
against these plain versions on the card (tests/test_torch_cuda.py and
chip_smoke.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.quantize import quantize_into as jquantize_into
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import common as jcm
from repro_torch.core.ops import REGISTRY, resolve_decode_backend
from repro_torch.core.quantize import dequantize_block, quantize_into
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import common as tcm

from conftest import assert_close
from test_torch_transformer import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-6)


def t(a):
    return torch.from_numpy(np.array(a))


def j(a):
    return jnp.asarray(np.array(a))


def _inputs(layout, quantized, *, b=3, h=8, kvh=2, d=32, s=40, seed=0,
            dtype=np.float32):
    rng = np.random.default_rng(seed)
    shape = (b, s, kvh, d) if layout == "bskd" else (b, kvh, s, d)
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    if quantized:
        k = rng.integers(-127, 128, shape).astype(np.int8)
        v = rng.integers(-127, 128, shape).astype(np.int8)
        ks = rng.uniform(0.01, 0.05, shape[:3]).astype(np.float32)
        vs = rng.uniform(0.01, 0.05, shape[:3]).astype(np.float32)
        return q, k, v, ks, vs
    k = rng.standard_normal(shape).astype(dtype)
    v = rng.standard_normal(shape).astype(dtype)
    return q, k, v


# ---------------------------------------------------------------------------
# B6 ring / B7 paged against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["bskd", "bksd"])
@pytest.mark.parametrize("quantized", [False, True])
def test_ring_matches_pallas(layout, quantized):
    """Ragged lanes: 1 slot, a partial block, the whole ring."""
    valid = np.array([1, 17, 40], np.int32)
    if quantized:
        q, k, v, ks, vs = _inputs(layout, True)
        want = jops.decode_attention_q8(j(q), j(k), j(v), j(ks), j(vs),
                                        j(valid), layout=layout, block_s=16)
        got = tops.decode_attention_q8(t(q), t(k), t(v), t(ks), t(vs),
                                       t(valid), layout=layout)
    else:
        q, k, v = _inputs(layout, False)
        want = jops.decode_attention(j(q), j(k), j(v), j(valid),
                                     layout=layout, block_s=16)
        got = tops.decode_attention(t(q), t(k), t(v), t(valid), layout=layout)
    assert_close(got, want, **TOL)


@pytest.mark.parametrize("layout", ["bskd", "bksd"])
@pytest.mark.parametrize("quantized", [False, True])
def test_paged_kernel_fragmented_out_of_order_pages(layout, quantized):
    """The port of test_paged.py's case: lanes' pages shuffled across the
    pool, against the Pallas paged kernel."""
    rng = np.random.default_rng(0)
    b, h, kvh, d, ps, w = 3, 8, 2, 32, 16, 4
    p = 1 + b * w + 3
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    shape = (p, ps, kvh, d) if layout == "bskd" else (p, kvh, ps, d)
    sshape = (p, ps, kvh) if layout == "bskd" else (p, kvh, ps)
    pt = rng.permutation(np.arange(1, p))[:b * w].reshape(b, w) \
        .astype(np.int32)
    valid = rng.integers(1, w * ps + 1, size=(b,)).astype(np.int32)
    if quantized:
        k = rng.integers(-127, 128, shape).astype(np.int8)
        v = rng.integers(-127, 128, shape).astype(np.int8)
        ks = rng.uniform(0.01, 0.05, sshape).astype(np.float32)
        vs = rng.uniform(0.01, 0.05, sshape).astype(np.float32)
        want = jops.decode_attention_paged_q8(j(q), j(k), j(v), j(ks), j(vs),
                                              j(pt), j(valid), layout=layout)
        got = tops.decode_attention_paged_q8(t(q), t(k), t(v), t(ks), t(vs),
                                             t(pt), t(valid), layout=layout)
    else:
        k = rng.standard_normal(shape).astype(np.float32)
        v = rng.standard_normal(shape).astype(np.float32)
        want = jops.decode_attention_paged(j(q), j(k), j(v), j(pt), j(valid),
                                           layout=layout)
        got = tops.decode_attention_paged(t(q), t(k), t(v), t(pt), t(valid),
                                          layout=layout)
    assert_close(got, want, **TOL)


@pytest.mark.parametrize("layout", ["bskd", "bksd"])
def test_plain_versions_match_jax_oracles(layout):
    """kernels/ref against kernels/ref of the JAX package: scalar and
    ragged valid lengths, bf16 caches, paged gathers."""
    q, k, v = _inputs(layout, False, seed=1)
    for valid in (np.int32(23), np.array([1, 40, 9], np.int32)):
        assert_close(tref.decode_attention_ref(t(q), t(k), t(v), t(valid),
                                               layout=layout),
                     jref.decode_attention_ref(j(q), j(k), j(v), j(valid),
                                               layout=layout), **TOL)
    kb, vb = (torch.from_numpy(x).to(torch.bfloat16) for x in (k, v))
    want = jref.decode_attention_ref(j(q), j(k).astype(jnp.bfloat16),
                                     j(v).astype(jnp.bfloat16),
                                     j(np.array([5, 40, 33], np.int32)),
                                     layout=layout)
    assert_close(tref.decode_attention_ref(t(q), kb, vb,
                                           t(np.array([5, 40, 33], np.int32)),
                                           layout=layout), want, **TOL)
    pool = np.random.default_rng(2).standard_normal((7, 4, 2, 8)) \
        .astype(np.float32)
    pt = np.array([[3, 1], [6, 0]], np.int32)
    np.testing.assert_array_equal(
        tref.paged_gather(t(pool), t(pt), layout=layout).numpy(),
        np.asarray(jref.paged_gather(j(pool), j(pt), layout=layout)))


def test_wrappers_raise_off_the_cpu():
    """A tensor that is not on the CPU launches the kernel or raises: a
    meta tensor is neither, so each wrapper must raise."""
    q = torch.empty(2, 8, 32, device="meta")
    k = torch.empty(2, 2, 16, 32, device="meta")
    s = torch.empty(2, 2, 16, device="meta")
    pt = torch.zeros(2, 1, dtype=torch.int32, device="meta")
    k8 = k.to(torch.int8)
    for call in (lambda: tops.decode_attention(q, k, k, 4, layout="bksd"),
                 lambda: tops.decode_attention_q8(q, k8, k8, s, s, 4,
                                                  layout="bksd"),
                 lambda: tops.decode_attention_paged(q, k, k, pt, 4,
                                                     layout="bksd"),
                 lambda: tops.decode_attention_paged_q8(q, k8, k8, s, s, pt, 4,
                                                        layout="bksd")):
        with pytest.raises(ValueError, match="CUDA device"):
            call()


def test_backend_names_resolve_like_jax():
    assert resolve_decode_backend(None) == "ref"
    assert resolve_decode_backend("auto", device="cuda") == "cuda"
    assert resolve_decode_backend("cuda", quantized=True, paged=True) == \
        "paged_cuda_q8"
    assert resolve_decode_backend("ref", paged=True) == "paged_ref"
    with pytest.raises(ValueError, match="palas"):
        resolve_decode_backend("palas")
    # the same eight implementations as the JAX registry, pallas -> cuda
    assert len(REGISTRY.op("decode_attention").backends) == 8


# ---------------------------------------------------------------------------
# models/common: norms, RoPE, attention, cache writes, the int8 quantizer
# ---------------------------------------------------------------------------


def test_rms_norm_rope_and_quantizer_match_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 4, 32)).astype(np.float32)
    w = (0.1 * rng.standard_normal(32)).astype(np.float32)
    assert_close(tcm.rms_norm(t(x), t(w), 1e-6),
                 jcm.rms_norm(j(x), j(w), 1e-6), **TOL)
    pos = np.array([[0, 1, 2, 60, 61], [7, 8, 9, 10, 11]], np.int32)
    for theta in (1e4, 1e6):
        assert_close(tcm.apply_rope(t(x), t(pos), theta),
                     jcm.apply_rope(j(x), j(pos), theta), **TOL)
    x[0, 0, 0] = 0.0                                 # an all-zero row
    x[1, 2, 3] = 0.0                                 # scale 1, ties at .5:
    x[1, 2, 3, :4] = [127.0, 62.5, -63.5, 0.5]       # half to even

    q, s = quantize_into(t(x), axis=-1)
    assert q[1, 2, 3, :4].tolist() == [127, 62, -64, 0]
    jq, js = jquantize_into(j(x), axis=-1)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert_close(dequantize_block(q, s), np.asarray(jq, np.float32)
                 * np.asarray(js)[..., None], rtol=0, atol=0)


@pytest.mark.parametrize("causal,window,chunk", [(True, 0, 8), (True, 5, 8),
                                                 (False, 0, 32), (True, 0, 7)])
def test_attention_chunked_matches_jax(causal, window, chunk):
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 32, 8, 16)).astype(np.float32)
    k = rng.standard_normal((2, 32, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 32, 2, 16)).astype(np.float32)
    kw = dict(causal=causal, window=window, q_chunk=chunk, k_chunk=chunk)
    assert_close(tcm.attention_chunked(t(q), t(k), t(v), **kw),
                 jcm.attention_chunked(j(q), j(k), j(v), **kw), **TOL)


@pytest.mark.parametrize("layout", ["bskd", "bksd"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_decode_matches_jax(layout, dtype):
    """The registry's ring ``ref``: with a bf16 cache, q and the
    probabilities are cast to bf16 first, on both sides."""
    q, k, v = _inputs(layout, False, seed=5)
    q4 = q[:, None]
    jk, jv = j(k).astype(dtype), j(v).astype(dtype)
    tk, tv = t(k).to(getattr(torch, dtype)), t(v).to(getattr(torch, dtype))
    for valid in (np.int32(11), np.array([40, 1, 26], np.int32)):
        assert_close(tcm.attention_decode(t(q4), tk, tv, t(valid), layout),
                     jcm.attention_decode(j(q4), jk, jv, j(valid), layout),
                     **TOL)


def test_cache_writes_match_jax():
    """The four lane-major writes, both seq axes; int8 payloads and scales
    bit-equal."""
    rng = np.random.default_rng(6)
    b, kvh, s, d, ps, w = 3, 2, 12, 8, 4, 3
    pos = np.array([0, 13, 5], np.int32)            # 13 wraps the ring
    pt = np.array([[2, 5, 1], [4, 3, 6], [0, 0, 0]], np.int32)
    for seq_axis in (2, 1):
        new_shape = (b, kvh, 1, d) if seq_axis == 2 else (b, 1, kvh, d)
        kn = rng.standard_normal(new_shape).astype(np.float32)
        vn = rng.standard_normal(new_shape).astype(np.float32)
        ring = (b, kvh, s, d) if seq_axis == 2 else (b, s, kvh, d)
        pool = (7, kvh, ps, d) if seq_axis == 2 else (7, ps, kvh, d)
        zeros = lambda shape, dt=np.float32: np.zeros(shape, dt)
        cases = [
            (tcm.cache_write_batch, jcm.cache_write_batch,
             [zeros(ring), zeros(ring)], []),
            (tcm.cache_write_batch_q8, jcm.cache_write_batch_q8,
             [zeros(ring, np.int8), zeros(ring, np.int8),
              zeros(ring[:3]), zeros(ring[:3])], []),
            (tcm.cache_write_batch_paged, jcm.cache_write_batch_paged,
             [zeros(pool), zeros(pool)], [pt]),
            (tcm.cache_write_batch_paged_q8, jcm.cache_write_batch_paged_q8,
             [zeros(pool, np.int8), zeros(pool, np.int8), zeros(pool[:3]),
              zeros(pool[:3])], [pt]),
        ]
        for tfn, jfn, bufs, table in cases:
            got = tfn(*map(t, bufs), *map(t, table), t(kn), t(vn), t(pos),
                      seq_axis=seq_axis)
            want = jfn(*map(j, bufs), *map(j, table), j(kn), j(vn), j(pos),
                       seq_axis=seq_axis)
            for g, wnt in zip(got, want):
                np.testing.assert_array_equal(g.numpy(), np.asarray(wnt))
    # the B=1-per-position write of the vmapped reference
    ck, cv = np.zeros((1, 2, s, d), np.float32), np.zeros((1, 2, s, d),
                                                          np.float32)
    kn = rng.standard_normal((1, 2, 1, d)).astype(np.float32)
    got = tcm.cache_write(t(ck), t(cv), t(kn), t(kn), 14, seq_axis=2)
    want = jcm.cache_write(j(ck), j(cv), j(kn), j(kn), 14, seq_axis=2)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
