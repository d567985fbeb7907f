"""RecurrentGemma (Griffin hybrid) parity: the port's RG-LRU, recurrent
block, model, scheduler path and artifacts against the JAX package's, on
the same numpy inputs.

The reduced recurrentgemma-9b of both packages: 3 layers (rec, rec,
attn), d_model 256, lru_width 256, 8 query heads and 1 KV head of 32,
local window 32, vocab 1024.  Weights are made once in numpy, never by
``jax.random`` (the JAX package's ``init_params`` salts its keys with
Python's ``hash``); zero-initialized leaves get small random values so
that every gate and bias is exercised.  Everything is held at 1e-4: both
sides compute in fp32 and differ in summation order only (the scan in
its tree: the JAX package's ``associative_scan`` against the port's
Hillis-Steele doubling).  Greedy scheduler tokens are identical, in ring
and paged form with fp32 and int8 windows, for streams that wrap the
window too.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jmodels
from repro.checkpoint import ckpt as jckpt
from repro.configs.base import SHAPES as JSHAPES
from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.core.modelstore import ModelStore as JStore
from repro.models import rglru as jrg
from repro.runtime.roofline import HWSpec as JHWSpec
from repro.runtime.roofline import RooflineAccountant as JAccountant
from repro.runtime.scheduler import ContinuousBatchingScheduler as JSched
from repro.runtime.scheduler import Request as JRequest
from repro_torch import models
from repro_torch.checkpoint import ckpt as tckpt
from repro_torch.configs.base import SHAPES, get_config, reduced
from repro_torch.convert import params_to_numpy
from repro_torch.core.modelstore import ModelStore as TStore
from repro_torch.models import rglru as trg
from repro_torch.runtime.roofline import RooflineAccountant
from repro_torch.runtime.scheduler import ContinuousBatchingScheduler as TSched
from repro_torch.runtime.scheduler import Request as TRequest

from test_torch_transformer import both_params, one_torch_thread  # noqa: F401

ARCH = "recurrentgemma-9b"
TOL = dict(rtol=1e-4, atol=1e-4)
CACHE_LEN = 64                  # the reduced window (32) caps the rings


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL,
                               err_msg=what)


@pytest.fixture(scope="module")
def model():
    cfg = reduced(get_config(ARCH))
    jp, tp = both_params(cfg)
    return jreduced(jget_config(ARCH)), cfg, jp, tp


def rec_layer(jp, tp, i=0):
    return ({k: v[i] for k, v in jp["rec"].items()},
            {k: v[i] for k, v in tp["rec"].items()})


# ---------------------------------------------------------------------------
# the config and the wiring
# ---------------------------------------------------------------------------


def test_config_module_and_windows_equal_jax():
    jcfg, cfg = jget_config(ARCH), get_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(reduced(cfg)) == \
        dataclasses.asdict(jreduced(jcfg))
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_size, cfg.lru_width,
            cfg.conv_width, cfg.attn_period, cfg.local_window) == \
        (38, 4096, 16, 1, 256, 12288, 256000, 4096, 4, 3, 2048)
    for c, jc in ((cfg, jcfg), (reduced(cfg), jreduced(jcfg))):
        assert c.param_count() == jc.param_count() == jmodels.param_count(jc)
        assert trg.layer_kinds(c) == jrg.layer_kinds(jc)
    assert cfg.param_count() == 10_444_984_320
    assert models.get_module(cfg) is trg
    assert trg.RING_WRAP_SAFE and jrg.RING_WRAP_SAFE
    assert trg.LRU_C == jrg.LRU_C
    assert set(SHAPES) == set(JSHAPES)
    for name in SHAPES:
        for c, jc in ((cfg, jcfg), (get_config("llama3-8b"),
                                    jget_config("llama3-8b"))):
            assert models.cache_len(c, SHAPES[name]) == \
                jmodels.cache_len(jc, JSHAPES[name])
            assert models.effective_window(c, SHAPES[name]) == \
                jmodels.effective_window(jc, JSHAPES[name])


def test_cache_spec_and_paged_info_equal_jax(model):
    jcfg, cfg, _, _ = model
    for cl in (16, 64):
        spec, axes = trg.cache_spec(cfg, 3, cl, torch.bfloat16)
        jspec, jaxes = jrg.cache_spec(jcfg, 3, cl, jnp.bfloat16)
        assert axes == jaxes
        assert {k: s for k, (s, _) in spec.items()} == \
            {k: tuple(v.shape) for k, v in jspec.items()}
        assert {k: str(d).split(".")[-1] for k, (_, d) in spec.items()} == \
            {k: str(v.dtype) for k, v in jspec.items()}
        assert trg.paged_info(cfg, cl, 16) == jrg.paged_info(jcfg, cl, 16)
    with pytest.raises(ValueError, match="must divide"):
        trg.paged_info(cfg, 64, 24)
    for kw in ({}, {"kv_dtype": "int8"}, {"page_size": 16},
               {"page_size": 8, "kv_dtype": "int8", "num_pages": 9}):
        tc = trg.init_cache(cfg, 2, CACHE_LEN, torch.float32, **kw)
        jc = jrg.init_cache(jcfg, 2, CACHE_LEN, jnp.float32, **kw)
        assert {k: tuple(v.shape) for k, v in tc.items()} == \
            {k: tuple(v.shape) for k, v in jc.items()}
        assert {k: str(v.dtype).split(".")[-1] for k, v in tc.items()} == \
            {k: str(v.dtype) for k, v in jc.items()}


# ---------------------------------------------------------------------------
# RG-LRU, the conv and the recurrent block
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_h0", [False, True], ids=["zero", "h0"])
@pytest.mark.parametrize("tlen", [1, 7, 64, 300])
def test_rg_lru_matches_associative_scan(model, tlen, with_h0):
    """The doubling scan against ``lax.associative_scan`` through the
    JAX rg_lru, from a zero state and from an incoming one: outputs and
    the last state."""
    _, _, jp, tp = model
    jlp, tlp = rec_layer(jp, tp, 1)
    rng = np.random.default_rng(tlen)
    x = rng.standard_normal((2, tlen, 256)).astype(np.float32)
    h0 = rng.standard_normal((2, 256)).astype(np.float32) if with_h0 \
        else None
    jy, jh = jrg.rg_lru(jlp, jnp.asarray(x),
                        None if h0 is None else jnp.asarray(h0))
    ty, th = trg.rg_lru(tlp, t(x), None if h0 is None else t(h0))
    assert th.dtype == torch.float32
    close(ty, jy, "y")
    close(th, jh, "h_last")


def test_linear_scan_is_the_fp64_recurrence():
    """The doubling against a sequential fp64 loop at T 1000, with slow
    decays (a near 1, long memory) and fast ones (a near e^-8, where a
    cumulative product underflows within a few dozen tokens)."""
    rng = np.random.default_rng(3)
    for lo, hi in ((0.9, 1.0), (3e-4, 0.1)):
        a = rng.uniform(lo, hi, (2, 1000, 64)).astype(np.float32)
        b = rng.standard_normal((2, 1000, 64)).astype(np.float32)
        want = np.zeros_like(b, dtype=np.float64)
        h = np.zeros((2, 64))
        for i in range(1000):
            h = a[:, i].astype(np.float64) * h + b[:, i]
            want[:, i] = h
        got = trg.linear_scan(t(a), t(b)).double().numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_step_and_conv_forms_match_jax(model):
    """rg_lru_step, causal_conv (from zeros and from a state) and
    causal_conv_step against the JAX functions; the step equals the scan
    of one token."""
    _, _, jp, tp = model
    jlp, tlp = rec_layer(jp, tp)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 9, 256)).astype(np.float32)
    h = rng.standard_normal((2, 256)).astype(np.float32)
    state = rng.standard_normal((2, 3, 256)).astype(np.float32)
    jo = jrg.rg_lru_step(jlp, jnp.asarray(x[:, 0]), jnp.asarray(h))
    to = trg.rg_lru_step(tlp, t(x[:, 0]), t(h))
    for a, b in zip(to, jo):
        close(a, b, "rg_lru_step")
    scan = trg.rg_lru(tlp, t(x[:, :1]), t(h))
    close(scan[0][:, 0], to[0], "step == scan of one token")
    for st in (None, state):
        jo = jrg.causal_conv(jlp, jnp.asarray(x),
                             None if st is None else jnp.asarray(st))
        to = trg.causal_conv(tlp, t(x), None if st is None else t(st))
        for a, b in zip(to, jo):
            close(a, b, "causal_conv")
    jo = jrg.causal_conv_step(jlp, jnp.asarray(x[:, 0]), jnp.asarray(state))
    to = trg.causal_conv_step(tlp, t(x[:, 0]), t(state))
    for a, b in zip(to, jo):
        close(a, b, "causal_conv_step")


@pytest.mark.parametrize("with_state", [False, True], ids=["zero", "state"])
def test_rec_block_matches_jax_with_tanh_gelu(model, with_state):
    """The recurrent block and its one-token step against the JAX ones.
    The block's GeLU is jax.nn.gelu's tanh form: the erf form, torch's
    default, moves the output past the bar."""
    jcfg, cfg, jp, tp = model
    jlp, tlp = rec_layer(jp, tp)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 21, cfg.d_model)).astype(np.float32)
    conv = rng.standard_normal((2, 3, 256)).astype(np.float32)
    h = rng.standard_normal((2, 256)).astype(np.float32)
    jst = (jnp.asarray(conv), jnp.asarray(h)) if with_state else (None, None)
    tst = (t(conv), t(h)) if with_state else (None, None)
    jo = jrg.rec_block(jcfg, jlp, jnp.asarray(x), *jst)
    to = trg.rec_block(cfg, tlp, t(x), *tst)
    for a, b in zip(to, jo):
        close(a, b, "rec_block")
    jo = jrg.rec_block_step(jcfg, jlp, jnp.asarray(x[:, 0]),
                            jnp.asarray(conv), jnp.asarray(h))
    to = trg.rec_block_step(cfg, tlp, t(x[:, 0]), t(conv), t(h))
    for a, b in zip(to, jo):
        close(a, b, "rec_block_step")
    tanh = trg.cm.gelu
    try:
        trg.cm.gelu = torch.nn.functional.gelu
        wrong = trg.rec_block(cfg, tlp, t(x), *tst)[0]
    finally:
        trg.cm.gelu = tanh
    with pytest.raises(AssertionError):
        close(wrong, jrg.rec_block(jcfg, jlp, jnp.asarray(x), *jst)[0])


# ---------------------------------------------------------------------------
# the model against JAX
# ---------------------------------------------------------------------------


def assert_cache_close(tcache, jcache):
    assert set(tcache) == set(jcache)
    for key in tcache:
        assert tuple(tcache[key].shape) == tuple(jcache[key].shape), key
        close(tcache[key].float(), np.asarray(jcache[key], np.float32), key)


@pytest.mark.parametrize("plen", [5, 19, 45, 70])
def test_prefill_and_teacher_forced_decode_match_jax(model, plen):
    """Prefill logits and cache for prompts shorter and longer than the
    window of 32 (the pad-and-roll), then 16 teacher-forced decode steps
    (logits, and the whole cache after them) across the ring's wrap."""
    jcfg, cfg, jp, tp = model
    toks = np.random.default_rng(plen).integers(1, cfg.vocab_size,
                                                (1, plen)).astype(np.int32)
    jl, jc = jrg.prefill(jcfg, jp, jnp.asarray(toks), CACHE_LEN,
                         cache_dtype=jnp.float32)
    tl, tc = trg.prefill(cfg, tp, t(toks).long(), CACHE_LEN,
                         cache_dtype=torch.float32)
    close(tl, jl, "prefill logits")
    assert_cache_close(tc, jc)
    feed = np.random.default_rng(plen + 1).integers(1, cfg.vocab_size, 16)
    for step, tok in enumerate(feed):
        tk = np.asarray([[tok]], np.int32)
        jl, jc = jrg.decode_step(jcfg, jp, jnp.asarray(tk), jc,
                                 jnp.int32(plen + step))
        tl, same = trg.decode_step(cfg, tp, t(tk).long(), tc, plen + step)
        assert same is tc                        # written in place
        close(tl, jl, f"decode step {step}")
    assert_cache_close(tc, jc)


def _lanes(cfg, tp, prompts, **cache_kw):
    """A B-lane ring cache with each prompt prefilled into its lane."""
    cache = trg.init_cache(cfg, len(prompts), CACHE_LEN, torch.float32,
                           **cache_kw)
    for i, p in enumerate(prompts):
        _, row = trg.prefill(cfg, tp, torch.tensor([p]), CACHE_LEN,
                             cache_dtype=torch.float32)
        row = trg.cache_to_kv_dtype(cfg, row, cache_kw.get("kv_dtype"))
        for key, c in cache.items():
            c[:, i] = row[key][:, 0]
    return cache


PROMPTS = [list(range(1, 6)), list(range(7, 47)), [9]]   # 5, 40 (> 32), 1


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["fp32", "int8"])
def test_decode_step_batch_is_decode_step_ring_and_paged(model, kv_dtype):
    """Three lanes at ragged positions, one past the wrap: the lane-major
    step equals decode_step on each lane alone (fp32), and the paged
    cache, spliced from the same rows, gives the ring's logits and
    state over 4 steps (both forms, fp32 and int8)."""
    _, cfg, _, tp = model
    ring = _lanes(cfg, tp, PROMPTS, kv_dtype=kv_dtype)
    paged = trg.init_cache(cfg, 3, CACHE_LEN, torch.float32, page_size=8,
                           kv_dtype=kv_dtype)
    for i, p in enumerate(PROMPTS):
        _, row = trg.prefill(cfg, tp, torch.tensor([p]), CACHE_LEN,
                             cache_dtype=torch.float32)
        row = trg.cache_to_kv_dtype(cfg, row, kv_dtype)
        pages = torch.arange(1 + 4 * i, 5 + 4 * i).flip(0)   # fragmented
        assert trg.cache_splice_paged(cfg, paged, row, i, pages, 8) is paged
    lanes = {k: c.clone() for k, c in ring.items()}
    pos = torch.tensor([len(p) for p in PROMPTS], dtype=torch.int32)
    for step in range(4):
        toks = torch.tensor([[11 + step], [12 + step], [13 + step]])
        lg, _ = trg.decode_step_batch(cfg, tp, toks, ring, pos)
        lp, _ = trg.decode_step_batch(cfg, tp, toks, paged, pos)
        close(lp, lg, f"paged vs ring, step {step}")
        if kv_dtype is None:
            for i in range(3):
                row = {k: c[:, i:i + 1] for k, c in lanes.items()}
                one, _ = trg.decode_step(cfg, tp, toks[i:i + 1], row, pos[i])
                close(lg[i], one[0], f"lane {i}, step {step}")
        pos = pos + 1
    for key in ("h", "conv"):
        close(paged[key], ring[key], key)
        if kv_dtype is None:
            close(ring[key], lanes[key], key)


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["fp32", "int8"])
@pytest.mark.parametrize("layout", ["ring", "paged"])
def test_decode_step_batch_matches_jax(model, layout, kv_dtype):
    """decode_step_batch against the JAX one on three ragged lanes, 4
    steps, in the four cache forms: logits and the state leaves."""
    jcfg, cfg, jp, tp = model
    kw = {"kv_dtype": kv_dtype}
    if layout == "paged":
        kw.update(page_size=16)
    tcache = trg.init_cache(cfg, 3, CACHE_LEN, torch.float32, **kw)
    jcache = jrg.init_cache(jcfg, 3, CACHE_LEN, jnp.float32, **kw)
    for i, p in enumerate(PROMPTS):
        _, jrow = jrg.prefill(jcfg, jp, jnp.asarray([p], jnp.int32),
                              CACHE_LEN, cache_dtype=jnp.float32)
        jrow = jrg.cache_to_kv_dtype(jcfg, jrow, kv_dtype)
        trow = {k: t(v) for k, v in jrow.items()}
        if layout == "paged":
            pages = np.arange(1 + 2 * i, 3 + 2 * i, dtype=np.int32)
            jcache = jrg.cache_splice_paged(jcfg, jcache, jrow, i,
                                            jnp.asarray(pages), 16)
            trg.cache_splice_paged(cfg, tcache, trow, i, t(pages), 16)
        else:
            jcache = {k: c.at[:, i].set(jrow[k][:, 0])
                      for k, c in jcache.items()}
            for k, c in tcache.items():
                c[:, i] = trow[k][:, 0]
    pos = np.asarray([len(p) for p in PROMPTS], np.int32)
    for step in range(4):
        toks = np.asarray([[21 + step], [22 + step], [23 + step]], np.int32)
        jl, jcache = jrg.decode_step_batch(jcfg, jp, jnp.asarray(toks),
                                           jcache, jnp.asarray(pos))
        tl, _ = trg.decode_step_batch(cfg, tp, t(toks).long(), tcache,
                                      t(pos))
        close(tl, jl, f"step {step}")
        pos = pos + 1
    for key in ("h", "conv"):
        close(tcache[key], jcache[key], key)


def test_cache_to_kv_dtype_leaves_the_recurrence(model):
    """bf16 and int8 convert only the window's K/V (the int8 payloads and
    scales bit-equal to JAX's); h and conv are the prefill's own
    tensors."""
    jcfg, cfg, jp, tp = model
    toks = np.asarray([PROMPTS[1]], np.int32)
    _, jrow = jrg.prefill(jcfg, jp, jnp.asarray(toks), CACHE_LEN,
                          cache_dtype=jnp.float32)
    _, row = trg.prefill(cfg, tp, t(toks).long(), CACHE_LEN,
                         cache_dtype=torch.float32)
    assert trg.cache_to_kv_dtype(cfg, row, None) is row
    for kv_dtype in ("bf16", "int8"):
        conv = trg.cache_to_kv_dtype(cfg, row, kv_dtype)
        assert conv["h"] is row["h"] and conv["conv"] is row["conv"]
        assert conv["h"].dtype == torch.float32
    q8 = trg.cache_to_kv_dtype(cfg, {k: t(v) for k, v in jrow.items()},
                               "int8")
    jq8 = jrg.cache_to_kv_dtype(jcfg, jrow, "int8")
    assert set(q8) == set(jq8)
    for key in ("k", "v", "k_scale", "v_scale"):
        np.testing.assert_array_equal(q8[key].numpy(), np.asarray(jq8[key]))
    assert conv["k"].dtype == torch.int8
    with pytest.raises(ValueError, match="kv_dtype"):
        trg.cache_to_kv_dtype(cfg, row, "fp8")


def _batch(cfg, b=2, s=40, seed=7):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s))
    return toks.astype(np.int32)


def test_forward_loss_and_grads_match_jax(model):
    """The forward (40 tokens: past the window) on both flash backends,
    then the loss and every gradient leaf against jax.value_and_grad,
    within 1e-4 (relative to each leaf's largest entry for the
    gradients)."""
    jcfg, cfg, jp, tp = model
    toks = _batch(cfg)
    jlog = jrg.forward(jcfg, jp, jnp.asarray(toks))
    with torch.no_grad():
        for backend in ("ref", None):
            tlog = trg.forward(cfg, tp, t(toks).long(), backend=backend)
            close(tlog, jlog, f"forward {backend}")
    batch = {"tokens": toks, "labels": toks}
    (jl, _), jg = jax.value_and_grad(
        lambda p: jrg.loss_fn(jcfg, p, {k: jnp.asarray(v)
                                        for k, v in batch.items()}),
        has_aux=True)(jp)
    params = jax.tree.map(lambda a: a.detach().clone().requires_grad_(), tp)
    tl, _ = trg.loss_fn(cfg, params, {k: t(v).long() for k, v in batch.items()})
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-4)
    flat_t = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda a: a.grad.numpy(), params))
    flat_j = dict(jax.tree_util.tree_leaves_with_path(jg))
    assert len(flat_t) == len(flat_j) == 23
    for path, g in flat_t:
        want = np.asarray(flat_j[path])
        scale = max(float(np.abs(want).max()), 1e-12)
        np.testing.assert_allclose(g / scale, want / scale, rtol=1e-4,
                                   atol=1e-4, err_msg=str(path))


# ---------------------------------------------------------------------------
# the scheduler path
# ---------------------------------------------------------------------------

# lane 0 runs 3 ticks ahead, so the lanes sit at ragged positions; the
# 40-token prompt is rolled into the window and every stream but the
# shortest ends past the wrap (positions past 32)
MIX = [[3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8, 9, 7, 9, 3, 2, 3, 8, 4],
       list(range(50, 90)), [2, 7]]
MAX_NEW = 16


def _ragged_run(cls_sched, cls_req, cfg, params, **kw):
    reqs = [cls_req(uid=i, prompt=list(p), max_new_tokens=MAX_NEW)
            for i, p in enumerate(MIX)]
    sched = cls_sched(cfg, params, max_slots=2, cache_len=CACHE_LEN,
                      max_new_cap=MAX_NEW, **kw)
    sched.submit(reqs[0])
    for _ in range(3):
        sched.tick()
    sched.submit(reqs[1])
    sched.submit(reqs[2])
    sched.run()
    assert all(len(r.output) == MAX_NEW for r in reqs)
    return [r.output for r in reqs], sched


_JAX_RING = {}


def jax_ring_tokens(model, kv_dtype):
    """The JAX scheduler's ring run of MIX with this kv_dtype."""
    if kv_dtype not in _JAX_RING:
        jcfg, _, jp, _ = model
        _JAX_RING[kv_dtype] = _ragged_run(JSched, JRequest, jcfg, jp,
                                          kv_dtype=kv_dtype)[0]
    return _JAX_RING[kv_dtype]


@pytest.mark.parametrize("opts", [
    {}, {"kv_dtype": "int8"}, {"kv_layout": "paged", "page_size": 16},
    {"kv_layout": "paged", "page_size": 16, "kv_dtype": "int8"},
    {"decode_mode": "vmapped"}],
    ids=["ring", "ring-int8", "paged", "paged-int8", "vmapped"])
def test_scheduler_tokens_match_jax(model, opts):
    """Greedy tokens equal the JAX scheduler's ring run with the same
    kv_dtype, streams past the window and the 40-token prompt included
    (the JAX scheduler refuses a paged prompt longer than the window:
    the port's takes it, rolled into the window as in the ring); paged
    lanes own their whole window (full allocation, no prefix sharing)
    and return every page."""
    _, cfg, _, tp = model
    got, sched = _ragged_run(TSched, TRequest, cfg, tp, **opts)
    assert got == jax_ring_tokens(model, opts.get("kv_dtype"))
    assert sched.host_syncs == len(MIX)
    assert sched.kv_layout == opts.get("kv_layout", "ring")
    assert sched.state["cache"]["h"].dtype == torch.float32
    if sched.kv_layout == "paged":
        assert sched._alloc_mode == "full" and not sched.prefix_sharing
        sched.audit_pages()


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["fp32", "int8"])
def test_paged_scheduler_matches_jax_paged(model, kv_dtype):
    """Against the JAX scheduler's own paged run, on prompts that fit the
    window, with 24 new tokens: every stream wraps its pages."""
    jcfg, cfg, jp, tp = model
    mix = [MIX[0], MIX[2], list(range(100, 130))]
    outs = []
    for sched_cls, req_cls, c, p in ((JSched, JRequest, jcfg, jp),
                                     (TSched, TRequest, cfg, tp)):
        s = sched_cls(c, p, max_slots=2, cache_len=CACHE_LEN,
                      max_new_cap=24, kv_layout="paged", page_size=8,
                      kv_dtype=kv_dtype)
        reqs = [req_cls(uid=i, prompt=list(x), max_new_tokens=24)
                for i, x in enumerate(mix)]
        for r in reqs:
            s.submit(r)
        s.run()
        outs.append([r.output for r in reqs])
    assert outs[0] == outs[1]


def test_prompt_longer_than_the_cache_is_rolled(model):
    """cache_len 32 (the window): the 40-token prompt is accepted by the
    port, ring and paged, and gives the JAX tokens at cache_len 64,
    whose rings are the same 32 slots."""
    _, cfg, _, tp = model
    for opts in ({}, {"kv_layout": "paged", "page_size": 16}):
        reqs = [TRequest(uid=i, prompt=list(p), max_new_tokens=MAX_NEW)
                for i, p in enumerate(MIX)]
        s = TSched(cfg, tp, max_slots=3, cache_len=32, max_new_cap=MAX_NEW,
                   **opts)
        for r in reqs:
            s.submit(r)
        s.run()
        assert sorted(r.output for r in reqs) == \
            sorted(jax_ring_tokens(model, None))


def test_scheduler_bf16_window_matches_jax(model):
    jcfg, cfg, jp, tp = model
    want, _ = _ragged_run(JSched, JRequest, jcfg, jp, kv_dtype="bf16")
    got, _ = _ragged_run(TSched, TRequest, cfg, tp, kv_dtype="bf16")
    assert got == want


def test_wrap_guard_skipped_for_long_streams(model):
    """A prompt plus generation longer than cache_len (not only the
    window) is accepted and gives the JAX tokens."""
    jcfg, cfg, jp, tp = model
    prompt = [int(x) for x in np.random.default_rng(9).integers(1, 1000, 12)]
    outs = []
    for sched_cls, req_cls, c, p in ((JSched, JRequest, jcfg, jp),
                                     (TSched, TRequest, cfg, tp)):
        s = sched_cls(c, p, max_slots=1, cache_len=16, max_new_cap=24)
        req = req_cls(uid=0, prompt=prompt, max_new_tokens=24)
        s.submit(req)
        s.run()
        outs.append(req.output)
    assert outs[0] == outs[1] and len(outs[1]) == 24


@pytest.mark.parametrize("paged", [False, True], ids=["ring", "paged"])
def test_roofline_bytes_per_token_equal_jax(model, paged):
    """The accountant keeps the window's slot group (capacity 32) apart
    from the recurrence's state bytes (h and conv, read and written per
    token), as the JAX one does."""
    jcfg, cfg, jp, tp = model
    kw = {"page_size": 16} if paged else {}
    jcache = jrg.init_cache(jcfg, 4, CACHE_LEN, jnp.float32, **kw)
    tcache = trg.init_cache(cfg, 4, CACHE_LEN, torch.float32, **kw)
    pkw = dict(paged=True, page_size=16, pages_per_lane=2) if paged else {}
    ja = JAccountant(jcfg, jcache, jp, batch=4, hw=JHWSpec.detect(), **pkw)
    ta = RooflineAccountant(cfg, tcache, tp, batch=4, **pkw)
    jd, td = ja.describe(), ta.describe()
    for key in ("slot_groups", "state_bytes_per_token",
                "fixed_bytes_per_token", "write_bytes_per_token",
                "weight_bytes_per_step", "linear_flops_per_token"):
        assert td[key] == jd[key], key
    assert [g["capacity"] for g in td["slot_groups"]] == [32]
    w = cfg.lru_width
    assert td["state_bytes_per_token"] == 2 * 4 * 2 * (w + 3 * w)
    for valid in (1, 17, 32, 200):
        assert ta.kv_read_bytes(valid) == ja.kv_read_bytes(valid)
        assert ta.token_bytes(valid) == ja.token_bytes(valid)
        assert ta.token_flops(valid) == ja.token_flops(valid)


# ---------------------------------------------------------------------------
# artifacts across the packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
def test_artifacts_cross_the_store_both_ways(tmp_path, model, int8):
    """A RecurrentGemma artifact published by either package loads in the
    other with the same config and numbers, and the port's prefill on it
    gives the JAX package's logits."""
    jcfg, cfg, jp, tp = model
    jckpt.publish_checkpoint(JStore(tmp_path), "from-jax", jcfg, jp,
                             int8=int8)
    tckpt.publish_checkpoint(TStore(tmp_path), "from-torch", cfg, tp,
                             int8=int8)
    cfg1, tp1, rec = tckpt.load_published(TStore(tmp_path), "from-jax")
    jcfg1, jp1, _ = jckpt.load_published(JStore(tmp_path), "from-torch")
    assert cfg1 == cfg and dataclasses.asdict(jcfg1) == dataclasses.asdict(cfg)
    assert rec.manifest["int8"] == int8
    got_t, got_j = params_to_numpy(tp1), jax.tree.map(np.asarray, jp1)
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_leaves_with_path(got_t),
            jax.tree_util.tree_leaves_with_path(got_j)):
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    toks = np.asarray([PROMPTS[1]], np.int32)
    jl, _ = jrg.prefill(jcfg, jax.tree.map(jnp.asarray, got_t),
                        jnp.asarray(toks), CACHE_LEN, cache_dtype=jnp.float32)
    tl, _ = trg.prefill(cfg, tp1, t(toks).long(), CACHE_LEN,
                        cache_dtype=torch.float32)
    close(tl, jl, "prefill on the artifact")
