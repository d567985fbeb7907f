"""MoE parity: the port's routing, dispatch, combine, model, cache forms
and scheduler path against the JAX package's, on the same numpy inputs.

The reduced Granite-MoE (GQA 3:1, tied embeddings) and Qwen3-MoE
(qk-norm, GQA 2:1) of both packages: 2 layers at d_model 256, 4 experts
top-2 of d_ff 128.  Weights are made once in numpy with nonzero norm
weights.  Routing is compared exactly where it is integer (top-k
experts, dispatch slots, drops) and within 1e-5 where it is float, with
a low ``capacity_factor`` so that tokens drop.  Logits, the loss and
every gradient leaf against ``jax.value_and_grad``, prefill and 8
teacher-forced lane-major decode steps in the four cache forms agree
within 1e-4: both sides compute in fp32 and differ in summation order
only.  Greedy scheduler tokens are identical.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.core.modelstore import ModelStore as JStore
from repro.checkpoint import ckpt as jckpt
from repro.kernels import ops as jops
from repro.models import moe as jmoe
from repro.runtime.scheduler import ContinuousBatchingScheduler as JSched
from repro.runtime.scheduler import Request as JRequest
from repro_torch import models
from repro_torch.checkpoint import ckpt as tckpt
from repro_torch.configs.base import get_config, reduced
from repro_torch.core.modelstore import ModelStore as TStore
from repro_torch.core.quantize import QTensor, quantize
from repro_torch.kernels import ops as tops
from repro_torch.models import moe as tmoe
from repro_torch.runtime.scheduler import ContinuousBatchingScheduler as TSched
from repro_torch.runtime.scheduler import Request as TRequest

from conftest import assert_close
from test_torch_scheduler import assert_same, run_both
from test_torch_transformer import both_params, one_torch_thread  # noqa: F401

ARCHS = ["granite-moe-3b-a800m", "qwen3-moe-235b-a22b"]
TOL = dict(rtol=1e-4, atol=1e-5)
ROUTE_TOL = dict(rtol=1e-5, atol=1e-6)


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    jcfg = jreduced(jget_config(request.param))
    cfg = reduced(get_config(request.param))
    jp, tp = both_params(cfg)
    return jcfg, cfg, jp, tp


def test_configs_and_param_counts_equal_jax():
    for name in ARCHS:
        jcfg, cfg = jget_config(name), get_config(name)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert dataclasses.asdict(reduced(cfg)) == \
            dataclasses.asdict(jreduced(jcfg))
        for c, jc in ((cfg, jcfg), (reduced(cfg), jreduced(jcfg))):
            assert c.param_count() == jc.param_count()
            assert c.active_param_count() == jc.active_param_count()
        assert models.get_module(cfg) is tmoe
    granite = get_config("granite-moe-3b-a800m")
    assert granite.param_count() == 3_298_793_472
    assert granite.active_param_count() == 882_874_368
    assert (granite.num_heads, granite.num_kv_heads, granite.head_dim) == \
        (24, 8, 64)


# ---------------------------------------------------------------------------
# routing, dispatch, combine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cf", [1.25, 0.25], ids=["cf1.25", "cf0.25-drops"])
@pytest.mark.parametrize("T", [1, 24, 40])
def test_route_dispatch_combine_match_jax(T, cf):
    """_route (top-k exact, probabilities and aux within 1e-5),
    _dispatch (destinations, drops, tokens and weights exact; the
    expert buffer bit-equal) and _combine within 1e-5 on the same expert
    outputs; with capacity_factor 0.25, T >= 24, tokens drop."""
    cfg = dataclasses.replace(reduced(get_config(ARCHS[0])),
                              capacity_factor=cf)
    jcfg = dataclasses.replace(jreduced(jget_config(ARCHS[0])),
                               capacity_factor=cf)
    rng = np.random.default_rng(T)
    d, E = cfg.d_model, cfg.num_experts
    xf = rng.standard_normal((T, d)).astype(np.float32)
    router = (rng.standard_normal((d, E)) / np.sqrt(d)).astype(np.float32)
    jp, je, jaux = jmoe._route(jcfg, jnp.asarray(xf), jnp.asarray(router))
    tp, te, taux = tmoe._route(cfg, t(xf), t(router))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    assert_close(tp, jp, **ROUTE_TOL)
    assert_close(taux, jaux, **ROUTE_TOL)
    C = tmoe._capacity(cfg, T)
    assert C == jmoe._capacity(jcfg, T)
    jbuf, jmeta = jmoe._dispatch(jnp.asarray(xf), je, jp, E, C)
    tbuf, tmeta = tmoe._dispatch(t(xf), te, t(np.asarray(jp)), E, C)
    np.testing.assert_array_equal(tbuf.numpy(), np.asarray(jbuf))
    for name, a, b in zip(("dest", "ok", "st", "sw"), tmeta, jmeta):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    if cf < 1 and T >= 24:
        assert int(tmeta[1].sum()) < T * cfg.experts_per_token  # drops
    y = rng.standard_normal((E * C, d)).astype(np.float32)
    assert_close(tmoe._combine(t(y), tmeta, T, torch.float32),
                 jmoe._combine(jnp.asarray(y), jmeta, T, jnp.float32),
                 **ROUTE_TOL)


@pytest.mark.parametrize("cf", [1.25, 0.25], ids=["cf1.25", "cf0.25-drops"])
def test_moe_ffn_dense_matches_jax(arch, cf):
    jcfg, cfg, jp, tp = arch
    cfg = dataclasses.replace(cfg, capacity_factor=cf)
    jcfg = dataclasses.replace(jcfg, capacity_factor=cf)
    x = np.random.default_rng(3).standard_normal(
        (2, 13, cfg.d_model)).astype(np.float32)
    jlp = jax.tree.map(lambda a: a[1], jp["layers"])
    tlp = {k: w[1] for k, w in tp["layers"].items()}
    jo, jaux = jmoe.moe_ffn_dense(jcfg, jlp, jnp.asarray(x))
    to, taux = tmoe.moe_ffn(cfg, tlp, t(x))
    assert_close(to, jo, **ROUTE_TOL)
    assert_close(taux, jaux, **ROUTE_TOL)


# ---------------------------------------------------------------------------
# the model: forward, loss, gradients
# ---------------------------------------------------------------------------


def test_forward_loss_and_grads_match_jax(arch):
    """Logits and aux on both flash backends, then the loss and every
    gradient leaf against jax.value_and_grad within 1e-4 (relative to
    each leaf's largest entry for the gradients)."""
    jcfg, cfg, jp, tp = arch
    toks = np.random.default_rng(7).integers(
        0, cfg.vocab_size, (2, 20)).astype(np.int32)
    jlog, jaux = jmoe.forward(jcfg, jp, jnp.asarray(toks))
    with torch.no_grad():
        for backend in ("ref", "cuda"):
            tlog, taux = tmoe.forward(cfg, tp, t(toks).long(),
                                      backend=backend)
            assert_close(tlog, jlog, **TOL)
            assert_close(taux, jaux, **TOL)
    batch = {"tokens": toks, "labels": toks}
    (jl, jm), jg = jax.value_and_grad(
        lambda p: jmoe.loss_fn(jcfg, p, {k: jnp.asarray(v)
                                         for k, v in batch.items()}),
        has_aux=True)(jp)
    params = jax.tree.map(lambda a: a.detach().clone().requires_grad_(), tp)
    tl, tm = tmoe.loss_fn(cfg, params,
                          {k: t(v).long() for k, v in batch.items()})
    tl.backward()
    assert set(tm) == set(jm) == {"loss", "xent", "aux"}
    for key in tm:
        np.testing.assert_allclose(float(tm[key].detach()), float(jm[key]),
                                   rtol=1e-4, err_msg=key)
    flat_t = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda a: a.grad.numpy(), params))
    flat_j = dict(jax.tree_util.tree_leaves_with_path(jg))
    assert len(flat_t) == len(flat_j)
    for path, g in flat_t:
        want = np.asarray(flat_j[path])
        scale = max(float(np.abs(want).max()), 1e-12)
        np.testing.assert_allclose(g / scale, want / scale, rtol=1e-4,
                                   atol=1e-4, err_msg=str(path))


# ---------------------------------------------------------------------------
# serving: prefill and the four cache forms
# ---------------------------------------------------------------------------

PROMPTS = [[3, 1, 4, 1, 5], [9, 2, 6, 5, 3, 5, 8, 9, 7, 9], [2, 7]]
CACHE_LEN = 32


def test_prefill_matches_jax(arch):
    """Prefill logits and ring caches, also for a ring shorter than the
    prompt (kept tail, rolled)."""
    jcfg, cfg, jp, tp = arch
    toks = np.random.default_rng(1).integers(
        1, cfg.vocab_size, (2, 12)).astype(np.int32)
    for cache_len in (16, 8):
        jl, jc = jmoe.prefill(jcfg, jp, jnp.asarray(toks), cache_len,
                              cache_dtype=jnp.float32)
        tl, tc = tmoe.prefill(cfg, tp, t(toks).long(), cache_len,
                              cache_dtype=torch.float32)
        assert_close(tl, jl, **TOL)
        for key in ("k", "v"):
            assert_close(tc[key], jc[key], **TOL)


@pytest.mark.parametrize("layout", ["ring", "paged"])
@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_decode_step_batch_matches_jax(arch, layout, kv_dtype):
    """8 teacher-forced steps of the lane-major decode from the same
    spliced cache (paged: fragmented, out-of-order pages): logits every
    step and the final cache."""
    jcfg, cfg, jp, tp = arch
    b, ps = len(PROMPTS), 8
    paged = layout == "paged"
    kw = dict(page_size=ps, num_pages=1 + 2 * b * (CACHE_LEN // ps) + 3) \
        if paged else {}
    jcache = jmoe.init_cache(jcfg, b, CACHE_LEN, jnp.float32,
                             kv_dtype=kv_dtype, **kw)
    tcache = tmoe.init_cache(cfg, b, CACHE_LEN, torch.float32,
                             kv_dtype=kv_dtype, **kw)
    w = CACHE_LEN // ps
    toks = []
    for i, p in enumerate(PROMPTS):
        lg, row = jmoe.prefill(jcfg, jp, jnp.asarray([p], jnp.int32),
                               CACHE_LEN, cache_dtype=jnp.float32)
        toks.append([int(np.argmax(np.asarray(lg[0, -1])))])
        jrow = jmoe.cache_to_kv_dtype(jcfg, row, kv_dtype)
        trow = tmoe.cache_to_kv_dtype(cfg, {k: t(v) for k, v in row.items()},
                                      kv_dtype)
        if paged:
            pages = np.arange(1 + 2 * w * i, 1 + 2 * w * (i + 1), 2)[::-1]
            jcache = jmoe.cache_splice_paged(jcfg, jcache, jrow, i,
                                             jnp.asarray(pages.copy(),
                                                         jnp.int32), ps)
            tmoe.cache_splice_paged(cfg, tcache, trow, i,
                                    t(pages.astype(np.int32)), ps)
        else:
            jcache = {k: c.at[:, i].set(jrow[k][:, 0])
                      for k, c in jcache.items()}
            for k, c in tcache.items():
                c[:, i] = trow[k][:, 0]
    pos = np.array([len(p) for p in PROMPTS], np.int32)
    toks = np.asarray(toks, np.int32)
    jstep = jax.jit(lambda c, tk, ps_: jmoe.decode_step_batch(
        jcfg, jp, tk, c, ps_, attn_backend="ref"))
    for _ in range(8):
        jl, jcache = jstep(jcache, jnp.asarray(toks), jnp.asarray(pos))
        tl, tcache = tmoe.decode_step_batch(cfg, tp, t(toks), tcache, t(pos),
                                            attn_backend="ref")
        assert_close(tl, jl, **TOL)
        toks = np.asarray(jnp.argmax(jl[:, -1], axis=-1), np.int32)[:, None]
        pos = pos + 1
    for k in jcache:
        if jcache[k].dtype == jnp.int8:
            # a rounding step may land on the other side of .5 at most
            assert np.abs(tcache[k].numpy().astype(np.int32)
                          - np.asarray(jcache[k], np.int32)).max() <= 1
        else:
            assert_close(tcache[k], jcache[k], **TOL)


def test_decode_step_batch_is_decode_step(arch):
    """As test_models.py holds the JAX package: aligned lanes through
    decode_step_batch equal decode_step at the scalar position (logits
    and cache); ragged lanes each equal a B=1 decode_step on its row."""
    _, cfg, _, tp = arch
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        1, cfg.vocab_size, (2, 9)))
    _, cache = tmoe.prefill(cfg, tp, toks, CACHE_LEN,
                            cache_dtype=torch.float32)
    tok = toks[:, -1:]
    c_s = {k: v.clone() for k, v in cache.items()}
    c_b = {k: v.clone() for k, v in cache.items()}
    lg_s, _ = tmoe.decode_step(cfg, tp, tok, c_s, 9)
    lg_b, _ = tmoe.decode_step_batch(cfg, tp, tok, c_b,
                                     torch.full((2,), 9, dtype=torch.int32))
    assert_close(lg_b, lg_s, rtol=1e-4, atol=1e-4)
    for k in cache:
        assert_close(c_b[k], c_s[k], rtol=1e-4, atol=1e-4)
    pos = torch.tensor([9, 2], dtype=torch.int32)
    c_b = {k: v.clone() for k, v in cache.items()}
    lg_b, _ = tmoe.decode_step_batch(cfg, tp, tok, c_b, pos)
    for i in range(2):
        row = {k: v[:, i:i + 1].clone() for k, v in cache.items()}
        lg_i, _ = tmoe.decode_step(cfg, tp, tok[i:i + 1], row, int(pos[i]))
        assert_close(lg_b[i], lg_i[0], rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the scheduler path
# ---------------------------------------------------------------------------

RAGGED = [[3, 1, 4, 1, 5], [2, 7], [9, 8, 7, 6]]


def _ragged_run(cls_sched, cls_req, cfg, params, **kw):
    """The mix of test_batched_decode_token_identical_to_vmapped: lane 0
    runs 3 ticks ahead, so the lanes sit at ragged positions."""
    reqs = [cls_req(uid=i, prompt=list(p), max_new_tokens=6)
            for i, p in enumerate(RAGGED)]
    sched = cls_sched(cfg, params, max_slots=2, cache_len=64, max_new_cap=16,
                      **kw)
    sched.submit(reqs[0])
    for _ in range(3):
        sched.tick()
    sched.submit(reqs[1])
    sched.submit(reqs[2])
    sched.run()
    assert all(len(r.output) == 6 for r in reqs)
    return [r.output for r in reqs], sched


_JAX_TOKENS = {}


@pytest.mark.parametrize("opts", [
    {}, {"decode_mode": "vmapped"}, {"kv_dtype": "int8"},
    {"kv_layout": "paged", "page_size": 16}],
    ids=["batched", "vmapped", "int8", "paged"])
def test_scheduler_tokens_match_jax(arch, opts):
    """The port in each mode and cache form against the JAX scheduler's
    batched ring run with the same kv_dtype (the JAX suite holds its
    vmapped and paged runs to that one)."""
    jcfg, cfg, jp, tp = arch
    key = (cfg.name, opts.get("kv_dtype"))
    if key not in _JAX_TOKENS:
        _JAX_TOKENS[key] = _ragged_run(JSched, JRequest, jcfg, jp,
                                       kv_dtype=key[1])[0]
    got, sched = _ragged_run(TSched, TRequest, cfg, tp, **opts)
    assert got == _JAX_TOKENS[key]
    assert sched.host_syncs == len(RAGGED)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_paged_prefix_sharing_matches_jax(arch, kv_dtype):
    """Three prompts sharing a 12-token prefix on 2 lanes: prefix hits
    feed their suffix through decode steps (where T is the lane count
    and idle lanes route too), copy-on-write forks, no page leaks."""
    base = [7, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11]
    mix = [dict(prompt=base + [20, 21], max_new_tokens=6),
           dict(prompt=base + [30], max_new_tokens=6),
           dict(prompt=base + [40, 41, 42], max_new_tokens=6)]
    res = run_both(arch, mix, kv_layout="paged", page_size=4,
                   kv_dtype=kv_dtype)
    assert_same(*res)
    ts = res[3]
    assert ts.prefix_hits >= 1 and ts.cow_copies >= 1
    ts.audit_pages()


def test_prefill_buckets_match_jax(arch):
    """Bucketed prefill pads the prompts on the left; the pads count in
    the capacity and route too, in both packages."""
    mix = [dict(prompt=[3, 1, 4, 1, 5], max_new_tokens=6),
           dict(prompt=[9, 2, 6], max_new_tokens=6),
           dict(prompt=[5, 3, 5, 8, 9, 7, 9, 3, 2, 7], max_new_tokens=4)]
    assert_same(*run_both(arch, mix, prefill_buckets=[4, 8, 16]))


# ---------------------------------------------------------------------------
# the int8 artifact: the feed of B11
# ---------------------------------------------------------------------------


def test_int8_artifact_feeds_int8_matmul(tmp_path, arch):
    """A MoE artifact published int8 by the JAX package loads in the port
    as QTensors scaled along the output columns; B11's wrapper on them
    and on per-row int8 activations equals the Pallas kernel (interpret
    mode) within rtol 1e-5, and the port's prefill on the dequantized
    tree gives the JAX package's logits."""
    jcfg, cfg, jp, tp = arch
    jckpt.publish_checkpoint(JStore(tmp_path), "moe", jcfg, jp, int8=True)
    rec = TStore(tmp_path).get("moe")
    q = rec.load_params(dequantize=False)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (5, cfg.d_model)).astype(np.float32))
    for key in ("wq", "we_gate", "we_down"):
        w = q["layers"][key]
        assert isinstance(w, QTensor) and w.axis == w.q.ndim - 1
        b = (w.q[0] if key == "wq" else w.q[0, 0]).contiguous()
        a = quantize(x[:, :b.shape[0]].contiguous(), axis=0)   # per row
        tops.reset_launches()
        got = tops.int8_matmul(a.q, b, a.scale, w.scale)
        assert tops.launches()["int8_matmul"] == 0     # the plain version
        want = jops.int8_matmul(*(jnp.asarray(v.numpy()) for v in
                                  (a.q, b, a.scale, w.scale)),
                                interpret=True)
        assert_close(got, want, rtol=1e-5, atol=0)
    cfg1, tp1, _ = tckpt.load_published(TStore(tmp_path), "moe")
    assert cfg1 == cfg
    toks = np.asarray([PROMPTS[1]], np.int32)
    jdq = jax.tree.map(jnp.asarray, jckpt.load_published(
        JStore(tmp_path), "moe")[1])
    jl, _ = jmoe.prefill(jcfg, jdq, jnp.asarray(toks), 16,
                         cache_dtype=jnp.float32)
    tl, _ = tmoe.prefill(cfg, tp1, t(toks).long(), 16,
                         cache_dtype=torch.float32)
    assert_close(tl, jl, **TOL)
