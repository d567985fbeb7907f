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
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import common as tcm

from conftest import assert_close
from test_torch_flash_attention import mm_tf32, tf32_rna
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
    meta q (which takes the CUDA path's checks and allocations, for the
    memory count) beside CPU caches must raise, never fall back."""
    q = torch.empty(2, 8, 32, device="meta")
    k = torch.empty(2, 2, 16, 32)
    s = torch.empty(2, 2, 16)
    pt = torch.zeros(2, 1, dtype=torch.int32)
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


# ---------------------------------------------------------------------------
# the split-KV kernel's plan and arithmetic (the kernel runs on the card;
# its chunking, tickets and merge order are held here)
# ---------------------------------------------------------------------------

SPLIT_TOL = dict(rtol=1e-4, atol=1e-5)     # chip_smoke.py's DECODE_TOL


def _ring_plan_edges(p):
    return [1, p.chunk - 1, p.chunk, p.chunk + 1, p.capacity,
            p.capacity + 9]


def test_plan_splits_the_ring_by_a_fixed_chunk():
    """TinyLlama's serving ring (8 lanes, 4 KV heads of 8 query heads of
    64, 1024 slots): n_split = capacity / chunk whatever the batch, the
    workspace holds the counters and each split's acc and (m, l)."""
    p = da.plan(8, 4, 8, 64, 4, slots=1024)
    assert p.chunk == da.CHUNK and p.capacity == 1024
    assert p.n_split == -(-1024 // da.CHUNK)
    assert p.ws_words == 32 + 8 * 4 * p.n_split * 8 * (64 + 2)
    assert p.smem == da.smem_bytes(8, 64, p.chunk, 4, False) <= da.SMEM_BUDGET
    assert da.plan(1, 4, 8, 64, 4, slots=1024)[:4] == p[:4]   # batch-free
    assert da.plan(8, 4, 8, 64, 4, slots=1000, chunk=64).n_split == 16
    with pytest.raises(ValueError, match="chunk"):
        da.plan(8, 4, 8, 64, 4, slots=1024, chunk=da.MAX_CHUNK + 1)


@pytest.mark.parametrize("chunk", [32, 64, 128])
def test_plan_tickets_at_the_chunk_edges(chunk):
    """Splits that work and tickets taken for valid_len at 0, 1, chunk-1,
    chunk, chunk+1, the capacity and past it: one split writes its output
    and takes no ticket; two or more take one each."""
    p = da.plan(8, 4, 8, 64, 4, slots=1024, chunk=chunk)
    want = {0: (0, 0), 1: (1, 0), chunk - 1: (1, 0), chunk: (1, 0),
            chunk + 1: (2, 2), 1024: (1024 // chunk, 1024 // chunk),
            5000: (1024 // chunk, 1024 // chunk)}
    for valid, (used, tickets) in want.items():
        assert da.splits_used(p, valid) == used, valid
        assert da.tickets(p, valid) == tickets, valid


@pytest.mark.parametrize("ps,chunk,want", [(16, 32, 32), (16, 64, 64),
                                           (16, 40, 32), (24, 64, 48),
                                           (8, 32, 32), (48, 32, 24),
                                           (64, 32, 32), (37, 32, 1)])
def test_plan_paged_chunk_is_whole_pages(ps, chunk, want):
    """Paged: the chunk is a multiple of the page size, or for pages longer
    than the chunk the largest divisor of ps under it, so a CTA reads each
    of its pages' ids once; the capacity is W * ps."""
    p = da.plan(8, 4, 8, 64, 1, slots=ps, page_size=ps, width=10,
                scaled=True, chunk=chunk)
    assert p.chunk == want
    assert p.chunk % ps == 0 or ps % p.chunk == 0
    assert p.capacity == 10 * ps and p.n_split == -(-10 * ps // want)
    assert da.tickets(p, 10 * ps) == (p.n_split if p.n_split > 1 else 0)


def test_plan_fits_the_widest_heads_in_shared_memory():
    """RecurrentGemma's 16 query heads of 256 on one KV head take the wide
    route, whose chunk of 64 fits one CTA an SM at every element size (a
    forced 128 halves for fp32's rows of 1 KB); the widest group the
    wrapper takes (32) keeps the FFMA route, whose chunk halves until two
    CTAs fit an SM; int8 rows take a quarter of fp32's."""
    for elem in (4, 2, 1):
        p = da.plan(8, 1, 16, 256, elem, slots=2048)
        assert p.wide and p.chunk == da.WIDE_CHUNK == 64
        assert p.smem == da.wide_smem_bytes(256, 64, elem, False) \
            <= da.WIDE_SMEM_BUDGET
        forced = da.plan(8, 1, 16, 256, elem, slots=2048, chunk=128)
        assert forced.wide and forced.chunk == (64 if elem == 4 else 128)
    for elem in (4, 2, 1):
        p = da.plan(8, 1, 32, 256, elem, slots=2048)
        assert not p.wide and p.smem <= da.SMEM_BUDGET and p.chunk >= 16
    assert da.plan(1, 1, 32, 256, 4, slots=2048).chunk == min(da.CHUNK, 32)


@pytest.mark.parametrize("g,d,wide", [(16, 256, True), (16, 128, True),
                                      (16, 32, True), (16, 40, False),
                                      (8, 256, False), (32, 256, False),
                                      (1, 64, False)])
def test_plan_takes_the_wide_route_for_groups_of_16(g, d, wide):
    """The route by shape: 16 query heads a KV head (mma's M) and a
    head_dim that four warps' n-tiles of 8 divide; every other (KV, G, D)
    keeps the FFMA route and its plan as before (CHUNK, the 112 KB
    budget)."""
    assert da.is_wide(g, d) == wide
    p = da.plan(8, 1, g, d, 4, slots=2048)
    assert p.wide == wide
    if not wide:
        want = da.CHUNK
        while want > 8 and da.smem_bytes(g, d, want, 4, False) > \
                da.SMEM_BUDGET:
            want //= 2
        assert p.chunk == want and p.smem == da.smem_bytes(g, d, want, 4,
                                                           False)


def test_plan_wide_chunk_workspace_and_tickets():
    """The wide route's chunk is a multiple of 32 (a warp's n-tiles of
    slots) and of whole pages: a forced chunk that is not, or pages that
    leave none, raise (no second route at G 16); paged int8 at
    RecurrentGemma's pages of 16 takes chunks of 64 (4 pages), pages
    longer than the chunk the largest multiple of 32 dividing them.  Its
    workspace has the FFMA route's layout (the counters unused), and it
    takes no tickets: the merge is a kernel of its own."""
    p = da.plan(8, 1, 16, 256, 1, slots=2048, scaled=True)
    assert p.wide and p.chunk == 64 and p.n_split == 32
    assert p.ws_words == 8 + 8 * 32 * 16 * (256 + 2)
    assert da.tickets(p, 2048) == 0 and da.splits_used(p, 300) == 5
    q = da.plan(8, 1, 16, 256, 1, slots=16, page_size=16, width=128,
                scaled=True)
    assert q.wide and q.chunk == 64 and q.capacity == 2048
    for forced in (16, 48, 100):
        with pytest.raises(ValueError, match="multiple of 32"):
            da.plan(8, 1, 16, 256, 4, slots=2048, chunk=forced)
    for ps in (24, 48):
        with pytest.raises(ValueError, match=f"pages of {ps} slots"):
            da.plan(8, 1, 16, 256, 4, slots=ps, page_size=ps, width=10)
    for ps, want in ((8, 64), (32, 64), (96, 32), (256, 64)):
        r = da.plan(8, 1, 16, 256, 4, slots=ps, page_size=ps, width=10)
        assert r.wide and r.chunk == want, ps
    assert da.plan(8, 1, 16, 256, 4, slots=2048, chunk=32).wide
    assert da.plan(1, 1, 16, 256, 4, slots=2048)[:4] == p._replace(
        chunk=64, n_split=32, capacity=2048,
        smem=da.wide_smem_bytes(256, 64, 4, False))[:4]


def test_vector_bytes_from_pointers_and_strides():
    """16-byte copies where every row start allows, 8 or 4 otherwise, 0
    (refused) below 4 bytes."""
    assert da.vector_bytes(4, 64, (262144, 65536, 64), 0x7f0000000000) == 16
    assert da.vector_bytes(2, 64, (262144, 65536, 64), 0x7f0000000008) == 8
    assert da.vector_bytes(1, 40, (81920, 40960, 40), 0x7f0000000000) == 8
    assert da.vector_bytes(1, 64, (4096, 1024, 64), 0x7f0000000004) == 4
    assert da.vector_bytes(1, 64, (4096, 1024, 64), 0x7f0000000001) == 0
    assert da.vector_bytes(2, 64, (4096, 1024, 64), 0x7f0000000002) == 0


def split_kv_emulation(q, k, v, valid, *, chunk, layout, scales=None,
                       page_table=None):
    """The kernel's arithmetic in plain torch fp32, in its order: per chunk
    of ``chunk`` slots of a lane's prefix, scores q.k x (1/sqrt(D)), times
    k_scale; m = max, p = e^(s - m), l = sum p, then p x v_scale; acc = p.V.
    One chunk writes acc / max(l, 1e-30); several merge in split order:
    m = max m_i, l = sum l_i e^(m_i - m), acc likewise."""
    if page_table is not None:
        k = tref.paged_gather(k, page_table, layout=layout)
        v = tref.paged_gather(v, page_table, layout=layout)
        if scales is not None:
            scales = tuple(tref.paged_gather(x, page_table, layout=layout)
                           for x in scales)
    if layout == "bskd":
        k, v = k.transpose(1, 2), v.transpose(1, 2)          # (B, KV, S, D)
        if scales is not None:
            scales = tuple(x.transpose(1, 2) for x in scales)
    b, h, d = q.shape
    kvh, cap = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, kvh, h // kvh, d)
    scale = torch.tensor(1.0 / np.sqrt(d), dtype=torch.float32)
    out = torch.empty(b, kvh, h // kvh, d)
    for lane in range(b):
        n = min(int(valid[lane]), cap)
        parts = []
        for t0 in range(0, n, chunk):
            sl = slice(t0, min(t0 + chunk, n))
            s = torch.einsum("kgd,ksd->kgs", qg[lane],
                             k[lane, :, sl].float()) * scale
            if scales is not None:
                s = s * scales[0][lane, :, None, sl]
            m = s.amax(-1, keepdim=True)
            p = torch.exp(s - m)
            l = p.sum(-1, keepdim=True)
            if scales is not None:
                p = p * scales[1][lane, :, None, sl]
            parts.append((m, l, torch.einsum("kgs,ksd->kgd", p,
                                             v[lane, :, sl].float())))
        m = torch.stack([x[0] for x in parts]).amax(0)
        l = torch.zeros_like(m)
        acc = torch.zeros_like(parts[0][2])
        for mi, li, ai in parts:                       # in split order
            f = torch.exp(mi - m)
            l = l + li * f
            acc = acc + ai * f
        out[lane] = acc / torch.clamp_min(l, 1e-30)
    return out.reshape(b, h, d)


def mm_3xtf32(a, b, b_exact=False):
    """a @ b as mma.sync's three TF32 products with hi = rna(x) and lo =
    x - hi read truncated (b exact in TF32, bf16 or int8 data: no hi.lo);
    fp32 sums.  The forward's emulation (``mm_tf32``) with its operand
    rules."""
    return mm_tf32(a, b, tf32_rna, tf32_rna, b_exact=b_exact)


def wide_emulation(q, k, v, valid, *, chunk, layout, scales=None,
                   page_table=None):
    """The wide route (16 query heads a KV head on mma.sync) in plain
    torch fp32, in its order: per chunk of a lane's prefix, s = q.k in
    3xTF32 (hi = rna, lo truncated) x (1/sqrt(D)) x k_scale; m = max,
    p = e^(s - m), l = sum p, p x v_scale; acc = p.V in 3xTF32 (V from
    bf16 or int8 exact: no hi.lo); one chunk writes acc / max(l, 1e-30),
    several are merged in split order by the merge kernel (m = max m_i,
    l = sum l_i e^(m_i - m), acc likewise)."""
    exact = k.dtype != torch.float32
    if page_table is not None:
        k = tref.paged_gather(k, page_table, layout=layout)
        v = tref.paged_gather(v, page_table, layout=layout)
        if scales is not None:
            scales = tuple(tref.paged_gather(x, page_table, layout=layout)
                           for x in scales)
    if layout == "bskd":
        k, v = k.transpose(1, 2), v.transpose(1, 2)          # (B, KV, S, D)
        if scales is not None:
            scales = tuple(x.transpose(1, 2) for x in scales)
    b, h, d = q.shape
    kvh, cap = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, kvh, h // kvh, d)
    scale = torch.tensor(1.0 / np.sqrt(d), dtype=torch.float32)
    out = torch.empty(b, kvh, h // kvh, d)
    for lane in range(b):
        n = min(int(valid[lane]), cap)
        parts = []
        for t0 in range(0, n, chunk):
            sl = slice(t0, min(t0 + chunk, n))
            kc, vc = k[lane, :, sl].float(), v[lane, :, sl].float()
            s = mm_3xtf32(qg[lane], kc.transpose(-1, -2), exact) * scale
            if scales is not None:
                s = s * scales[0][lane, :, None, sl]
            m = s.amax(-1, keepdim=True)
            p = torch.exp(s - m)
            l = p.sum(-1, keepdim=True)
            if scales is not None:
                p = p * scales[1][lane, :, None, sl]
            parts.append((m, l, mm_3xtf32(p, vc, exact)))
        m = torch.stack([x[0] for x in parts]).amax(0)
        l = torch.zeros_like(m)
        acc = torch.zeros_like(parts[0][2])
        for mi, li, ai in parts:                       # in split order
            f = torch.exp(mi - m)
            l = l + li * f
            acc = acc + ai * f
        out[lane] = acc / torch.clamp_min(l, 1e-30)
    return out.reshape(b, h, d)


@pytest.mark.parametrize("layout", ["bskd", "bksd"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_wide_route_matches_pallas_ring_at_g16_d256(layout, dtype):
    """The wide route emulated (3xTF32 products, the chunk the plan
    gives, the merge in split order) against JAX's Pallas decode_attention
    (interpret mode) at RecurrentGemma's group: 16 query heads of 256 on
    one KV head, a 300-slot ring, valid lengths on the chunk's edges, at
    the capacity and past it (clamped); SPLIT_TOL (chip_smoke.py's
    DECODE_TOL).  bf16 caches are held to Pallas on the same bf16 values
    cast to fp32."""
    b, h, kvh, d, s = 7, 16, 1, 256, 300
    elem = {"float32": 4, "bfloat16": 2, "int8": 1}[dtype]
    p = da.plan(b, kvh, h // kvh, d, elem, slots=s, scaled=dtype == "int8")
    assert p.wide
    valid = np.array(_ring_plan_edges(p) + [2 * p.chunk - 3], np.int32)
    ins = _inputs(layout, dtype == "int8", b=b, h=h, kvh=kvh, d=d, s=s,
                  seed=21)
    q, k, v = ins[:3]
    if dtype == "bfloat16":
        kt, vt = (t(x).to(torch.bfloat16) for x in (k, v))
        k, v = (x.float().numpy() for x in (kt, vt))
    else:
        kt, vt = t(k), t(v)
    sc = tuple(t(x) for x in ins[3:]) if dtype == "int8" else None
    got = wide_emulation(t(q), kt, vt, valid, chunk=p.chunk, layout=layout,
                         scales=sc)
    if dtype == "int8":
        want = jops.decode_attention_q8(j(q), j(k), j(v), j(ins[3]),
                                        j(ins[4]), j(valid), layout=layout,
                                        block_s=20)
    else:
        want = jops.decode_attention(j(q), j(k), j(v), j(valid),
                                     layout=layout, block_s=20)
    assert_close(got, want, **SPLIT_TOL)


def test_wide_route_matches_pallas_paged_int8_at_g16_d256():
    """The wide route emulated over RecurrentGemma's paged int8 pools
    (pages of 16 shuffled across the pool, chunks of 4 pages) against
    JAX's Pallas decode_attention_paged_q8 (interpret mode)."""
    rng = np.random.default_rng(22)
    b, h, kvh, d, ps, w = 4, 16, 1, 256, 16, 20
    pool = 1 + b * w
    p = da.plan(b, kvh, h // kvh, d, 1, slots=ps, page_size=ps, width=w,
                scaled=True)
    assert p.wide and p.chunk == 64
    valid = np.array([1, p.chunk, p.chunk + 1, w * ps], np.int32)
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    shape = (pool, ps, kvh, d)
    pt = rng.permutation(np.arange(1, pool)).reshape(b, w).astype(np.int32)
    k = rng.integers(-127, 128, shape).astype(np.int8)
    v = rng.integers(-127, 128, shape).astype(np.int8)
    ks = rng.uniform(0.01, 0.05, shape[:3]).astype(np.float32)
    vs = rng.uniform(0.01, 0.05, shape[:3]).astype(np.float32)
    want = jops.decode_attention_paged_q8(j(q), j(k), j(v), j(ks), j(vs),
                                          j(pt), j(valid), layout="bskd")
    got = wide_emulation(t(q), t(k), t(v), valid, chunk=p.chunk,
                         layout="bskd", scales=(t(ks), t(vs)),
                         page_table=t(pt))
    assert_close(got, want, **SPLIT_TOL)


def test_wide_emulation_needs_three_tf32_products():
    """The negative control: with hi.hi alone (one TF32 product a dot)
    the wide route's output breaks DECODE_TOL against the fp32 plain
    version at G 16, D 256, where three products hold it."""
    b, h, kvh, d, s = 4, 16, 1, 256, 300
    q, k, v = _inputs("bskd", False, b=b, h=h, kvh=kvh, d=d, s=s, seed=23)
    valid = np.array([40, 130, 256, 300], np.int32)
    want = tops.decode_attention(t(q), t(k), t(v), t(valid), layout="bskd")
    got = wide_emulation(t(q), t(k), t(v), valid, chunk=64, layout="bskd")
    assert_close(got, want, **SPLIT_TOL)
    one = tops.decode_attention(tf32_rna(t(q)), tf32_rna(t(k)),
                                tf32_rna(t(v)), t(valid), layout="bskd")
    with pytest.raises(AssertionError):
        assert_close(one, want, **SPLIT_TOL)


@pytest.mark.parametrize("layout", ["bskd", "bksd"])
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("chunk", [16, 32])
def test_split_kv_merge_matches_pallas_ring(layout, quantized, chunk):
    """The emulated split-KV kernel against JAX's Pallas decode_attention
    (interpret mode) on a 96-slot ring, valid lengths on the chunk's edges
    and at the capacity; and against the port's plain version with
    valid_len past the capacity (clamped)."""
    b, h, kvh, d, s = 6, 8, 2, 32, 96
    p = da.plan(b, kvh, h // kvh, d, 1 if quantized else 4, slots=s,
                scaled=quantized, chunk=chunk)
    valid = np.array(_ring_plan_edges(p)[:5] + [2 * p.chunk], np.int32)
    ins = _inputs(layout, quantized, b=b, h=h, kvh=kvh, d=d, s=s, seed=7)
    q, k, v = ins[:3]
    sc = tuple(t(x) for x in ins[3:]) if quantized else None
    got = split_kv_emulation(t(q), t(k), t(v), valid, chunk=p.chunk,
                             layout=layout, scales=sc)
    if quantized:
        want = jops.decode_attention_q8(j(q), j(k), j(v), j(ins[3]),
                                        j(ins[4]), j(valid), layout=layout,
                                        block_s=16)
    else:
        want = jops.decode_attention(j(q), j(k), j(v), j(valid),
                                     layout=layout, block_s=16)
    assert_close(got, want, **SPLIT_TOL)
    past = np.array(_ring_plan_edges(p)[4:] * 3, np.int32)
    got = split_kv_emulation(t(q), t(k), t(v), past, chunk=p.chunk,
                             layout=layout, scales=sc)
    plain = tops.decode_attention_q8 if quantized else tops.decode_attention
    args = (t(q), t(k), t(v)) + (sc or ()) + (t(past),)
    assert_close(got, plain(*args, layout=layout), **SPLIT_TOL)


@pytest.mark.parametrize("layout", ["bskd", "bksd"])
@pytest.mark.parametrize("quantized", [False, True])
def test_split_kv_merge_matches_pallas_paged(layout, quantized):
    """The emulated split-KV kernel against JAX's Pallas
    decode_attention_paged (interpret mode): pages of 16 shuffled across
    the pool, chunks of two pages, valid lengths on chunk and page edges
    and at the capacity."""
    rng = np.random.default_rng(8)
    b, h, kvh, d, ps, w = 5, 8, 2, 32, 16, 6
    pool = 1 + b * w
    p = da.plan(b, kvh, h // kvh, d, 1 if quantized else 4, slots=ps,
                page_size=ps, width=w, scaled=quantized)
    assert p.chunk % ps == 0
    valid = np.array([1, p.chunk, p.chunk + 1, p.chunk + ps + 3, w * ps],
                     np.int32)
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    shape = (pool, ps, kvh, d) if layout == "bskd" else (pool, kvh, ps, d)
    pt = rng.permutation(np.arange(1, pool)).reshape(b, w).astype(np.int32)
    if quantized:
        k = rng.integers(-127, 128, shape).astype(np.int8)
        v = rng.integers(-127, 128, shape).astype(np.int8)
        ks = rng.uniform(0.01, 0.05, shape[:3]).astype(np.float32)
        vs = rng.uniform(0.01, 0.05, shape[:3]).astype(np.float32)
        want = jops.decode_attention_paged_q8(j(q), j(k), j(v), j(ks), j(vs),
                                              j(pt), j(valid), layout=layout)
        sc = (t(ks), t(vs))
    else:
        k = rng.standard_normal(shape).astype(np.float32)
        v = rng.standard_normal(shape).astype(np.float32)
        want = jops.decode_attention_paged(j(q), j(k), j(v), j(pt), j(valid),
                                           layout=layout)
        sc = None
    got = split_kv_emulation(t(q), t(k), t(v), valid, chunk=p.chunk,
                             layout=layout, scales=sc, page_table=t(pt))
    assert_close(got, want, **SPLIT_TOL)


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
