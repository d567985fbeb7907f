"""B8 / B9 parity: the port's full-sequence flash attention and its
FlashAttention-2 backward against the JAX package's Pallas kernels
(interpret mode on the CPU), on the same numpy inputs.

On the CPU the wrappers run their plain versions (``kernels/ref.py``):
B8 is the materialized attention, B9's forward returns (o, lse) and its
backward is the plain FA-2 recompute from (q, k, v, o, lse, dO), run
through the port's ``torch.autograd.Function``.  So these tests hold the
port's recompute arithmetic, its GQA group sums and its masks against
the reference's kernels; the CUDA kernels are held against the same
plain versions on the card (tests/test_torch_cuda.py, chip_smoke.py).

Tolerances: fp32 outputs rtol 1e-4 / atol 1e-5 (both sides compute in
fp32 and differ in summation order only); fp32 gradients rtol 1e-3 /
atol 1e-4, the JAX suite's own bar for its fused backward
(tests/test_kernels.py); bf16 rtol 3e-2 / atol 3e-2, the JAX suite's bf16
bar (the plain version rounds p to bf16 before the PV product, the
Pallas kernel keeps it in fp32).
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.flash_attention_bwd import _bwd as jbwd
from repro.kernels.flash_attention_bwd import _fwd as jfwd
from repro.kernels.flash_attention_bwd import \
    flash_attention_trainable as jtrainable
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import common as tcm

from conftest import assert_close

OUT_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=1e-3, atol=1e-4)
BF16_TOL = dict(rtol=3e-2, atol=3e-2)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def qkv(b, s, h, kv, d, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((b, s, h, d), (b, s, kv, d), (b, s, kv, d)))


def t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


# ---------------------------------------------------------------------------
# B8: forward, at the JAX suite's shapes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s,h,kv,d", [(256, 8, 8, 64),   # MHA
                                      (256, 8, 4, 64),   # GQA
                                      (512, 4, 1, 64),   # MQA
                                      (128, 2, 2, 128)])
def test_flash_attention_head_layouts_match_pallas(s, h, kv, d):
    q, k, v = qkv(2, s, h, kv, d)
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = tops.flash_attention(t(q), t(k), t(v))
    assert_close(got, want, **OUT_TOL)


@pytest.mark.parametrize("window", [32, 64, 128])
def test_flash_attention_sliding_window_matches_pallas(window):
    q, k, v = qkv(1, 256, 4, 2, 32, seed=1)
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), window=window)
    got = tops.flash_attention(t(q), t(k), t(v), window=window)
    assert_close(got, want, **OUT_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_dtypes_match_pallas(dtype):
    q, k, v = qkv(1, 128, 4, 4, 64, seed=2)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jops.flash_attention(*(jnp.asarray(x, jdt) for x in (q, k, v)))
    got = tops.flash_attention(*(t(x).to(tdt) for x in (q, k, v)))
    assert got.dtype == tdt
    tol = OUT_TOL if dtype == "float32" else BF16_TOL
    assert_close(got.float(), jnp.asarray(want, jnp.float32), **tol)


def test_flash_attention_is_causal():
    """Perturbing the last token leaves every earlier output unchanged."""
    q, k, v = qkv(1, 128, 2, 2, 32, seed=3)
    base = tops.flash_attention(t(q), t(k), t(v))
    k[:, -1] += 10.0
    v[:, -1] += 10.0
    pert = tops.flash_attention(t(q), t(k), t(v))
    np.testing.assert_allclose(base[:, :-1], pert[:, :-1], rtol=1e-5)
    assert float((base[:, -1] - pert[:, -1]).abs().max()) > 1e-3


# ---------------------------------------------------------------------------
# B9: the forward's lse and each backward piece against the Pallas kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("h,kv,window", [(4, 4, 0), (4, 2, 0), (4, 1, 0),
                                         (4, 2, 32)])
def test_flash_backward_pieces_match_pallas(h, kv, window):
    """(o, lse) of the forward, then dq and the group-summed dk/dv from
    the same residuals and dO, piece by piece."""
    b, s, d = 1, 128, 32
    q, k, v = qkv(b, s, h, kv, d, seed=4)
    do = np.random.default_rng(5).standard_normal((b, s, h, d)) \
        .astype(np.float32)
    kw = dict(causal=True, window=window, block_q=64, block_k=64,
              interpret=True)
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    jo_flat, jlse = jfwd(jq, jk, jv, **kw)
    jo = jo_flat.reshape(b, h, s, d).transpose(0, 2, 1, 3)
    jdq, jdk, jdv = jbwd((jq, jk, jv, jo, jlse), jdo, **kw)

    o, lse = tfa.flash_fwd_lse(t(q), t(k), t(v), causal=True, window=window)
    assert_close(o, jo, **OUT_TOL)
    assert_close(lse, np.asarray(jlse).reshape(b, h, s), **OUT_TOL)
    # the backward pieces from the reference's own residuals
    lse_r = t(np.asarray(jlse).reshape(b, h, s))
    res = (t(q), t(k), t(v), t(do), lse_r, tfa.dsum_of(t(jo), t(do)))
    assert_close(tfa.flash_dq(*res, causal=True, window=window), jdq,
                 **GRAD_TOL)
    dk, dv = tfa.flash_dkv(*res, causal=True, window=window)
    assert_close(dk, jdk, **GRAD_TOL)
    assert_close(dv, jdv, **GRAD_TOL)


@pytest.mark.parametrize("h,kv,window", [(4, 4, 0), (4, 2, 0), (4, 1, 0),
                                         (4, 2, 32)])
def test_flash_attention_trainable_grads_match_pallas(h, kv, window):
    """The autograd Function's gradients of sum(sin(o)) against jax.grad
    of the Pallas custom VJP (tests/test_kernels.py:419-446's shapes)."""
    q, k, v = qkv(1, 128, h, kv, 32, seed=6)

    def jloss(q, k, v):
        return jnp.sum(jnp.sin(jtrainable(q, k, v, True, window, 64, 64,
                                          True)))
    jo = jtrainable(*map(jnp.asarray, (q, k, v)), True, window, 64, 64, True)
    jg = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))

    leaves = [t(x).requires_grad_() for x in (q, k, v)]
    o = tops.flash_attention_trainable(*leaves, True, window)
    torch.sin(o).sum().backward()
    assert_close(o.detach(), jo, **OUT_TOL)
    for name, leaf, want in zip("qkv", leaves, jg):
        assert_close(leaf.grad, want, **GRAD_TOL, err_msg=f"d{name}")


def test_flash_attention_trainable_bf16_grads_keep_dtypes():
    q, k, v = qkv(1, 64, 4, 2, 32, seed=7)
    leaves = [t(x).to(torch.bfloat16).requires_grad_() for x in (q, k, v)]
    o = tops.flash_attention_trainable(*leaves)
    o.float().square().sum().backward()
    assert o.dtype == torch.bfloat16
    assert all(x.grad.dtype == torch.bfloat16 for x in leaves)
    ref = [t(x).requires_grad_() for x in (q, k, v)]
    tref.flash_attention_ref(*ref).square().sum().backward()
    for leaf, want in zip(leaves, ref):
        assert_close(leaf.grad.float(), want.grad, rtol=5e-2, atol=5e-2)


# ---------------------------------------------------------------------------
# head_dim 256 and Sq != Sk: every entry point, values and grads
# ---------------------------------------------------------------------------

# (B, Sq, Sk, H, KV, D, causal, window), Pallas blocks of 32: RecurrentGemma's
# local attention (16/1 heads of 256, a window); cross attention with fewer
# query rows than keys (Whisper's prefill), causal and not; and query rows
# that no key can see (Sq > Sk + window - 1), whose output is the mean of v
# and whose lse is -1e30 in the reference
SQ_SK = [(1, 64, 64, 16, 1, 256, True, 32),
         (1, 32, 96, 16, 1, 256, False, 0),
         (1, 64, 192, 4, 4, 64, False, 0),
         (1, 64, 192, 4, 2, 32, True, 0),
         (2, 128, 64, 4, 2, 32, True, 32),
         (1, 96, 32, 2, 1, 64, False, 16)]


@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal,window", SQ_SK)
def test_flash_sq_sk_and_head_dim_256_match_pallas(b, sq, sk, h, kv, d,
                                                   causal, window):
    """B8's output, B9's (o, lse), and dq and dk/dv from the reference's
    own residuals, each against the Pallas kernels in interpret mode."""
    rng = np.random.default_rng(10)
    q, do = (rng.standard_normal((b, sq, h, d)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((b, sk, kv, d)).astype(np.float32)
            for _ in range(2))
    kw = dict(causal=causal, window=window, block_q=32, block_k=32,
              interpret=True)
    mask = dict(causal=causal, window=window)
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    jo_flat, jlse = jfwd(jq, jk, jv, **kw)
    jo = jo_flat.reshape(b, h, sq, d).transpose(0, 2, 1, 3)
    jdq, jdk, jdv = jbwd((jq, jk, jv, jo, jlse), jdo, **kw)
    assert_close(jops.flash_attention(jq, jk, jv, block_q=32, block_k=32,
                                      **mask), jo, **OUT_TOL)

    assert_close(tops.flash_attention(t(q), t(k), t(v), **mask), jo,
                 **OUT_TOL)
    o, lse = tfa.flash_fwd_lse(t(q), t(k), t(v), **mask)
    assert_close(o, jo, **OUT_TOL)
    assert_close(lse, np.asarray(jlse).reshape(b, h, sq), **OUT_TOL)
    lse_r = t(np.asarray(jlse).reshape(b, h, sq))
    res = (t(q), t(k), t(v), t(do), lse_r, tfa.dsum_of(t(jo), t(do)))
    assert_close(tfa.flash_dq(*res, **mask), jdq, **GRAD_TOL)
    dk, dv = tfa.flash_dkv(*res, **mask)
    assert dk.shape == (b, sk, kv, d)
    assert_close(dk, jdk, **GRAD_TOL)
    assert_close(dv, jdv, **GRAD_TOL)


@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal,window", SQ_SK)
def test_flash_trainable_sq_sk_and_head_dim_256_grads_match_pallas(
        b, sq, sk, h, kv, d, causal, window):
    """The autograd Function's output and gradients of sum(sin(o)) against
    jax.grad of the Pallas custom VJP."""
    rng = np.random.default_rng(11)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, sk, kv, d)).astype(np.float32)
            for _ in range(2))

    def jloss(q, k, v):
        return jnp.sum(jnp.sin(jtrainable(q, k, v, causal, window, 32, 32,
                                          True)))
    args = tuple(map(jnp.asarray, (q, k, v)))
    jo = jtrainable(*args, causal, window, 32, 32, True)
    jg = jax.grad(jloss, argnums=(0, 1, 2))(*args)

    leaves = [t(x).requires_grad_() for x in (q, k, v)]
    o = tops.flash_attention_trainable(*leaves, causal, window)
    torch.sin(o).sum().backward()
    assert_close(o.detach(), jo, **OUT_TOL)
    for name, leaf, want in zip("qkv", leaves, jg):
        assert_close(leaf.grad, want, **GRAD_TOL, err_msg=f"d{name}")


# ---------------------------------------------------------------------------
# the numerical premise of B9's tensor-core backward: 3xTF32 products hold
# the fp32 grad bar
# ---------------------------------------------------------------------------


def tf32_rna(x):
    """x rounded to TF32 (10 mantissa bits) to nearest, ties away from
    zero, on the low 13 bits of the fp32 pattern (cvt.rna.tf32.f32)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_truncate(x):
    """x truncated to TF32 (the low 13 bits cleared), as the tensor core
    reads a .tf32 operand whose low bits are set."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def mm_3xtf32(a, b, lo_round=tf32_rna):
    """a @ b in 3xTF32: each operand split as hi = rna(x), lo = x - hi
    rounded by ``lo_round``, then lo.hi + hi.lo + hi.hi with fp32 sums."""
    ah, bh = tf32_rna(a), tf32_rna(b)
    al, bl = lo_round(a - ah), lo_round(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def mm_1xtf32(a, b):
    """a @ b in one TF32 product: hi.hi alone."""
    return tf32_rna(a) @ tf32_rna(b)


def bwd_tf32(q, k, v, do, lse, dsum, causal, window, mm=mm_3xtf32):
    """dq, dk, dv of B9's backward (the kernels' arithmetic: scaled,
    masked scores, p = exp(s - lse), ds = p (dO v^T - dsum) scale, dk/dv
    summed over each KV head's group) with every product through ``mm``
    (3xTF32 unless told otherwise)."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    g, scale = h // kvh, 1.0 / np.sqrt(d)
    qh, doh = q.transpose(1, 2), do.transpose(1, 2)          # (B, H, S, D)
    kh = k.repeat_interleave(g, dim=2).transpose(1, 2)
    vh = v.repeat_interleave(g, dim=2).transpose(1, 2)
    s = mm(qh, kh.transpose(-1, -2)) * np.float32(scale)
    qpos = torch.arange(sq)[:, None]
    kpos = torch.arange(sk)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    p = torch.exp(torch.where(mask, s, -1e30) - lse[..., None])
    dp = mm(doh, vh.transpose(-1, -2))
    ds = p * (dp - dsum[..., None]) * np.float32(scale)
    dq = mm(ds, kh).transpose(1, 2)
    dk = mm(ds.transpose(-1, -2), qh).reshape(b, kvh, g, sk, d).sum(2)
    dv = mm(p.transpose(-1, -2), doh).reshape(b, kvh, g, sk, d).sum(2)
    return dq, dk.transpose(1, 2), dv.transpose(1, 2)


def test_tf32_rounding_keeps_ten_mantissa_bits_ties_away():
    x = torch.tensor([1 + 2 ** -11, 1 + 3 * 2 ** -11, -(1 + 2 ** -11),
                      1 + 2 ** -11 - 2 ** -20, 3.0], dtype=torch.float32)
    want = torch.tensor([1 + 2 ** -10, 1 + 2 ** -9, -(1 + 2 ** -10), 1.0,
                         3.0])
    assert torch.equal(tf32_rna(x), want)
    y = torch.from_numpy(np.random.default_rng(0).standard_normal(4096)
                         .astype(np.float32))
    hi = tf32_rna(y)
    assert float(((y - hi) / y).abs().max()) <= 2 ** -11
    assert float(((y - hi - tf32_rna(y - hi)) / y).abs().max()) < 2 ** -21
    assert float(((y - hi - tf32_truncate(y - hi)) / y).abs().max()) < 2 ** -20
    assert torch.equal(tf32_truncate(x), torch.tensor(
        [1.0, 1 + 2 ** -10, -1.0, 1.0, 3.0]))


@pytest.mark.parametrize("lo_round", [tf32_rna, tf32_truncate],
                         ids=["lo-rna", "lo-truncated"])
@pytest.mark.parametrize("window", [0, 48])
def test_3xtf32_backward_matches_pallas(window, lo_round):
    """The kernels' 3xTF32 products, emulated in torch, give dq, dk and dv
    within the fp32 grad bar of the Pallas backward (interpret mode), at
    a GQA shape (8 query heads on 2 KV heads, head dim 64, 127 rows):
    with lo rounded to nearest as cvt.rna.tf32 would, and truncated as
    the tensor core reads the kernels' unrounded lo."""
    b, s, h, kv, d = 1, 127, 8, 2, 64
    q, k, v = qkv(b, s, h, kv, d, seed=12)
    do = np.random.default_rng(13).standard_normal((b, s, h, d)) \
        .astype(np.float32)
    kw = dict(causal=True, window=window, block_q=s, block_k=s,
              interpret=True)
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    jo_flat, jlse = jfwd(jq, jk, jv, **kw)
    jo = jo_flat.reshape(b, h, s, d).transpose(0, 2, 1, 3)
    want = jbwd((jq, jk, jv, jo, jlse), jdo, **kw)
    lse = t(np.asarray(jlse).reshape(b, h, s))
    got = bwd_tf32(t(q), t(k), t(v), t(do), lse, tfa.dsum_of(t(jo), t(do)),
                   True, window, partial(mm_3xtf32, lo_round=lo_round))
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        assert_close(x, y, **GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("s,h,kv", [(127, 8, 2), (2048, 4, 1)],
                         ids=["s127", "s2048"])
def test_1xtf32_backward_misses_the_fp32_grad_bar(s, h, kv):
    """The negative control of the test above: with one TF32 product
    (hi.hi alone) every one of dq, dk and dv breaks the fp32 grad bar
    (rtol 1e-3 / atol 1e-4) against the fp32 plain version, where 3xTF32
    holds it, at that test's shape and at the train length 2048.  Its
    relative norm stays under 1e-3 all the same: a norm bar of 1e-3
    (chip_smoke's TRAIN_GRAD_REL) cannot tell the two apart, the
    elementwise bar can."""
    d, window = 64, 0
    q, k, v = map(t, qkv(1, s, h, kv, d, seed=12))
    do = t(np.random.default_rng(13).standard_normal((1, s, h, d))
           .astype(np.float32))
    o, lse = tref.flash_fwd_lse_ref(q, k, v, causal=True, window=window)
    res = (q, k, v, do, lse, tfa.dsum_of(o, do))
    want = (tref.flash_dq_ref(*res, causal=True, window=window),
            *tref.flash_dkv_ref(*res, causal=True, window=window))
    three = bwd_tf32(*res, True, window)
    one = bwd_tf32(*res, True, window, mm=mm_1xtf32)
    for name, x3, x1, y in zip(("dq", "dk", "dv"), three, one, want):
        assert_close(x3, y, **GRAD_TOL, err_msg=name)
        with pytest.raises(AssertionError):
            assert_close(x1, y, **GRAD_TOL, err_msg=name)
        assert float((x1 - y).norm() / y.norm()) < 1e-3


# ---------------------------------------------------------------------------
# the numerical premise of the tensor-core forward (B8, B9's forward on
# wgmma): its schedule in 3xTF32, emulated step by step, holds the fp32 bar
# ---------------------------------------------------------------------------

# The kernel stores V^T's keys in each group of 8 in this order, so that k
# slot t of p.V's A fragment (the score accumulator's column 2t) and slot
# t + 4 (column 2t + 1) meet the same key.
PV_KEY_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)


def mm_tf32(a, b, a_hi, b_hi, a_exact=False, b_exact=False, products=3):
    """a @ b as the forward's wgmma products: each operand split as
    hi = ``a_hi(x)`` / ``b_hi(x)`` and lo = x - hi, read truncated to TF32
    by the tensor core, and lo.hi + hi.lo + hi.hi (``products`` 1: hi.hi
    alone); an operand exact in TF32 (bf16 data) drops its lo term."""
    ah, bh = a_hi(a), b_hi(b)
    out = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
    if products == 3 and not a_exact:
        out = out + tf32_truncate(a - ah) @ tf32_truncate(bh)
    if products == 3 and not b_exact:
        out = out + tf32_truncate(ah) @ tf32_truncate(b - bh)
    return out + tf32_truncate(ah) @ tf32_truncate(bh)


def fwd_tf32(q, k, v, causal, window, products=3, kr=64, halves=1):
    """(o, lse) of the tensor-core forward, its schedule step by step:
    key tiles of ``kr`` (zero-filled past Sk), masked scores (-1e30) and
    the others scaled by scale * log2(e), the online softmax in log2 units
    (p = 2^(s - m), m, l, corr), each tile's p.V summed apart with p's
    columns as k slots and V^T's keys in PV_KEY_ORDER within each group of
    8, then o = o corr + part; lse = m ln 2 + log(l) (-1e30 + log(l) where
    no key was seen).  Products in 3xTF32 (``products`` 1: hi.hi alone)
    with hi = rna(x) for every operand; bf16 inputs are exact in TF32, so
    q, k and v drop their lo terms (p, fp32, never does).  ``halves`` 2 is
    the head-dim-256 kernel's split of q.k^T: each half of the head dim
    summed apart (one warpgroup each), then added in fp32."""
    exact = q.dtype == torch.bfloat16
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = np.float32(np.float32(1.0 / np.sqrt(d)) * np.float32(np.log2(np.e)))
    nk = -(-sk // kr) * kr
    pad = (0, 0, 0, 0, 0, nk - sk)
    qh = q.float().transpose(1, 2)                            # (B, H, Sq, D)
    kh = torch.nn.functional.pad(k.float(), pad).repeat_interleave(
        g, dim=2).transpose(1, 2)
    vh = torch.nn.functional.pad(v.float(), pad).repeat_interleave(
        g, dim=2).transpose(1, 2)
    order = torch.tensor([8 * j + e for j in range(kr // 8)
                          for e in PV_KEY_ORDER])
    qpos = torch.arange(sq)[:, None]
    m = torch.full((b, h, sq), -1e30)
    l = torch.zeros((b, h, sq))
    acc = torch.zeros((b, h, sq, d))
    for k0 in range(0, nk, kr):
        kpos = torch.arange(k0, k0 + kr)[None, :]
        mask = (kpos < sk).expand(sq, kr)
        if causal:
            mask = mask & (kpos <= qpos)
        if window:
            mask = mask & (kpos > qpos - window)
        kt = kh[:, :, k0:k0 + kr].transpose(-1, -2)
        w = d // halves
        s = sum(mm_tf32(qh[..., i * w:(i + 1) * w], kt[..., i * w:(i + 1) * w, :],
                        tf32_rna, tf32_rna, exact, exact, products)
                for i in range(halves))
        s = torch.where(mask, s * scale, torch.tensor(-1e30))
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp2(m - m_new)
        p = torch.where(kpos < sk, torch.exp2(s - m_new[..., None]),
                        torch.tensor(0.0))
        l = l * corr + p.sum(-1)
        m = m_new
        vt = vh[:, :, k0:k0 + kr]
        part = mm_tf32(p[..., order], vt[:, :, order], tf32_rna, tf32_rna,
                       False, exact, products)
        acc = acc * corr[..., None] + part
    lf = torch.clamp_min(l, 1e-30)
    o = (acc / lf[..., None]).transpose(1, 2).to(q.dtype)
    m = torch.where(m == -1e30, m, m * np.float32(np.log(2.0)))
    return o, m + torch.log(lf)


def test_pv_key_order_matches_the_score_accumulator():
    """Thread (g, t) of a warp holds score columns 8j + 2t and 8j + 2t + 1
    of its rows (the m64nN accumulator); handed on as p.V's A fragment they
    sit in k slots t and t + 4 (the m64k8 A layout).  V^T's key at slot
    kappa of group j must be the key that slot holds."""
    for t_ in range(4):
        slot_t, slot_t4 = t_, t_ + 4
        assert PV_KEY_ORDER[slot_t] == 2 * t_
        assert PV_KEY_ORDER[slot_t4] == 2 * t_ + 1
    assert sorted(PV_KEY_ORDER) == list(range(8))
    # a product with p's columns in slot order and V^T's keys permuted the
    # same way is the same sum; permuting one side alone is not
    rng = np.random.default_rng(20)
    p = torch.from_numpy(rng.random((4, 64)).astype(np.float32))
    vv = torch.from_numpy(rng.standard_normal((64, 16)).astype(np.float32))
    order = torch.tensor([8 * j + e for j in range(8) for e in PV_KEY_ORDER])
    assert_close(p[:, order] @ vv[order], p @ vv, rtol=1e-6, atol=1e-6)
    with pytest.raises(AssertionError):
        assert_close(p[:, order] @ vv, p @ vv, rtol=1e-3, atol=1e-3)


def _pallas_fwd(q, k, v, s, window, dtype):
    """o of _flash_kernel (B8) and (o, lse) of _fwd_kernel (B9's
    forward), both in interpret mode, blocks of 100 rows at S 300."""
    jdt = getattr(jnp, dtype)
    jq, jk, jv = (jnp.asarray(x, jdt) for x in (q, k, v))
    blk = 100 if s == 300 else s
    b8 = jops.flash_attention(jq, jk, jv, window=window, block_q=blk,
                              block_k=blk)
    o_flat, lse = jfwd(jq, jk, jv, causal=True, window=window, block_q=blk,
                       block_k=blk, interpret=True)
    b, _, h, d = q.shape
    o = o_flat.reshape(b, h, s, d).transpose(0, 2, 1, 3)
    return (np.asarray(jnp.asarray(b8, jnp.float32)),
            np.asarray(jnp.asarray(o, jnp.float32)),
            np.asarray(lse).reshape(b, h, s))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("g", [8, 2])
@pytest.mark.parametrize("window", [0, 64])
@pytest.mark.parametrize("s", [127, 300])
def test_3xtf32_forward_matches_pallas(s, window, g, dtype):
    """The forward's wgmma schedule in 3xTF32 (hi rounded to nearest),
    emulated in torch, gives o and lse within the fp32 bar (bf16: the bf16
    bar) of _flash_kernel and _fwd_kernel in interpret mode: 8 query heads
    on 8 / g KV heads of 64, causal."""
    h, d = 8, 64
    q, k, v = qkv(1, s, h, h // g, d, seed=14)
    want8, want_o, want_lse = _pallas_fwd(q, k, v, s, window, dtype)
    tdt = getattr(torch, dtype)
    o, lse = fwd_tf32(*(t(x).to(tdt) for x in (q, k, v)), True, window)
    assert o.dtype == tdt
    tol = OUT_TOL if dtype == "float32" else BF16_TOL
    assert_close(o.float(), want_o, **tol, err_msg="o vs _fwd_kernel")
    assert_close(o.float(), want8, **tol, err_msg="o vs _flash_kernel")
    assert_close(lse, want_lse, **OUT_TOL, err_msg="lse")


def test_1xtf32_forward_misses_the_fp32_bar():
    """The negative control of the test above: with one TF32 product
    (hi.hi alone) o breaks the fp32 bar (rtol 1e-4 / atol 1e-5) against
    _fwd_kernel at its longest case, where 3xTF32 holds it."""
    s, window, h, g, d = 300, 0, 8, 8, 64
    q, k, v = qkv(1, s, h, h // g, d, seed=14)
    _, want_o, _ = _pallas_fwd(q, k, v, s, window, "float32")
    three, _ = fwd_tf32(t(q), t(k), t(v), True, window)
    one, _ = fwd_tf32(t(q), t(k), t(v), True, window, products=1)
    assert_close(three, want_o, **OUT_TOL)
    with pytest.raises(AssertionError):
        assert_close(one, want_o, **OUT_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 64])
@pytest.mark.parametrize("s", [127, 300])
def test_3xtf32_forward_at_head_dim_256_matches_pallas(s, window, dtype):
    """The head-dim-256 forward's schedule (key tiles of 32, q.k^T summed
    by head-dim halves and added, 3xTF32 with hi rounded to nearest),
    emulated in torch, against _flash_kernel and _fwd_kernel in interpret
    mode at RecurrentGemma's group (16 query heads of 256 on one KV head),
    causal, with and without a window: o within the fp32 bar (bf16: the
    bf16 bar), lse within the fp32 bar."""
    h, d = 16, 256
    q, k, v = qkv(1, s, h, 1, d, seed=15)
    want8, want_o, want_lse = _pallas_fwd(q, k, v, s, window, dtype)
    tdt = getattr(torch, dtype)
    o, lse = fwd_tf32(*(t(x).to(tdt) for x in (q, k, v)), True, window,
                      kr=32, halves=2)
    assert o.dtype == tdt
    tol = OUT_TOL if dtype == "float32" else BF16_TOL
    assert_close(o.float(), want_o, **tol, err_msg="o vs _fwd_kernel")
    assert_close(o.float(), want8, **tol, err_msg="o vs _flash_kernel")
    assert_close(lse, want_lse, **OUT_TOL, err_msg="lse")


def test_1xtf32_forward_at_head_dim_256_misses_the_fp32_bar():
    """The negative control at head dim 256: hi.hi alone breaks the fp32
    bar against _fwd_kernel at 1 x 300, 16 heads on one KV head, where
    the kernel's three products hold it."""
    s, h, d = 300, 16, 256
    q, k, v = qkv(1, s, h, 1, d, seed=15)
    _, want_o, _ = _pallas_fwd(q, k, v, s, 0, "float32")
    three, _ = fwd_tf32(t(q), t(k), t(v), True, 0, kr=32, halves=2)
    one, _ = fwd_tf32(t(q), t(k), t(v), True, 0, products=1, kr=32,
                      halves=2)
    assert_close(three, want_o, **OUT_TOL)
    with pytest.raises(AssertionError):
        assert_close(one, want_o, **OUT_TOL)


# ---------------------------------------------------------------------------
# the named backends of the model's full-sequence attention
# ---------------------------------------------------------------------------


def test_flash_attention_named_resolves_and_agrees():
    q, k, v = (t(x) for x in qkv(2, 96, 4, 2, 32, seed=8))
    assert tcm.resolve_flash_backend(None, "cpu") == "ref"
    assert tcm.resolve_flash_backend("auto", "cpu") == "ref"
    assert tcm.resolve_flash_backend(None, torch.device("cuda")) == "cuda"
    with pytest.raises(ValueError, match="unknown flash attention backend"):
        tcm.flash_attention_named(q, k, v, backend="pallas")
    ref_out = tcm.flash_attention_named(q, k, v, window=40)
    assert torch.equal(ref_out, tcm.attention_chunked(q, k, v, window=40))
    for name in ("ref", "cuda"):
        got = tcm.flash_attention_named(q, k, v, window=40, backend=name)
        assert_close(got, ref_out, **OUT_TOL)
    assert tcm.flash_backend_of(None) is None
    assert tcm.flash_backend_of("paged_ref_q8") == "ref"
    assert tcm.flash_backend_of("paged_cuda") == "cuda"


def test_cpu_flash_calls_count_no_launch():
    tops.reset_launches()
    q, k, v = (t(x).requires_grad_() for x in qkv(1, 16, 2, 1, 64, seed=9))
    tops.flash_attention(q, k, v)
    tops.flash_attention_trainable(q, k, v).sum().backward()
    assert tops.launches() == {n: 0 for n in tops.KERNELS}


@pytest.mark.parametrize("call", [
    lambda x, y: tops.flash_attention(x, y, y),
    lambda x, y: tfa.flash_fwd_lse(x, y, y),
    lambda x, y: tfa.flash_dq(x, y, y, x, x[..., 0].transpose(1, 2),
                              x[..., 0].transpose(1, 2)),
    lambda x, y: tfa.flash_dkv(x, y, y, x, x[..., 0].transpose(1, 2),
                               x[..., 0].transpose(1, 2)),
])
def test_flash_wrappers_never_fall_back(call):
    """A tensor that is not on the CPU launches the kernel or raises: a
    meta q (which takes the CUDA path's checks and allocations, for the
    memory count) beside CPU k and v must raise."""
    with pytest.raises(ValueError, match="CUDA device"):
        call(torch.empty(1, 8, 2, 64, device="meta"),
             torch.empty(1, 8, 2, 64))
