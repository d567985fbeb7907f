"""Whisper-style encoder-decoder parity: the port's ``models/encdec.py``,
its norms and MLP, the scheduler path, the roofline and artifacts against
the JAX package's, on the same numpy inputs.

The reduced whisper-medium of both packages: 2 encoder and 2 decoder
layers, d_model 256, 8 heads of 32 (MHA), d_ff 512, vocab 1024,
encoder_seq 64.  Weights are made once in numpy, never by ``jax.random``
(the JAX package's ``init_params`` salts its keys with Python's
``hash``); LayerNorm weights get 1 + small noise and zero-initialized
leaves (biases) small random values, so that every bias and norm is
exercised.  The serving encoder sees zero frames (the scheduler passes
none), which gives every request the same encoder output, so the model
tests also feed random frames.  Everything is held at 1e-4: both sides
compute in fp32 and differ in summation order only (grads: 1e-3 in
relative norm per leaf).  Greedy scheduler tokens equal the JAX
scheduler's in ring and paged form, fp32, bf16 and int8.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jmodels
from repro.checkpoint import ckpt as jckpt
from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.core.modelstore import ModelStore as JStore
from repro.models import common as jcm
from repro.models import encdec as jed
from repro.runtime.roofline import HWSpec as JHWSpec
from repro.runtime.roofline import RooflineAccountant as JAccountant
from repro.runtime.scheduler import ContinuousBatchingScheduler as JSched
from repro.runtime.scheduler import Request as JRequest
from repro_torch import models
from repro_torch.checkpoint import ckpt as tckpt
from repro_torch.configs.base import get_config, reduced
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core.modelstore import ModelStore as TStore
from repro_torch.models import common as cm
from repro_torch.models import encdec as ted
from repro_torch.runtime.roofline import RooflineAccountant
from repro_torch.runtime.scheduler import ContinuousBatchingScheduler as TSched
from repro_torch.runtime.scheduler import Request as TRequest

from test_torch_transformer import one_torch_thread  # noqa: F401

ARCH = "whisper-medium"
TOL = dict(rtol=1e-4, atol=1e-4)
CACHE_LEN = 48
PROMPTS = [[3, 1, 4, 1, 5], [9, 2, 6, 5, 3, 5, 8, 9, 7, 9], [2, 7]]


# the JAX functions, compiled once per shape (eager, their lax.scan bodies
# compile again at every call)
J_PREFILL = jax.jit(jed.prefill, static_argnums=(0, 3),
                    static_argnames=("cache_dtype",))
J_DECODE = jax.jit(jed.decode_step, static_argnums=(0,))
J_DECODE_BATCH = jax.jit(jed.decode_step_batch, static_argnums=(0,))


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL,
                               err_msg=what)


def numpy_params(cfg, seed=0):
    """Weights at the JAX package's scales from one numpy seed; norm
    weights 1 + N(0, 0.1), biases and norm biases N(0, 0.1)."""
    rng = np.random.default_rng(seed)

    def leaf(p):
        x = rng.standard_normal(p.shape)
        if p.init == "ones":
            return (1.0 + 0.1 * x).astype(np.float32)
        std = 0.1 if p.init == "zeros" else p.std
        return (std * x).astype(np.float32)
    return cm.map_template(leaf, models.param_template(cfg))


@pytest.fixture(scope="module")
def model():
    cfg = reduced(get_config(ARCH))
    np_params = numpy_params(cfg)
    return (jreduced(jget_config(ARCH)), cfg,
            jax.tree.map(jnp.asarray, np_params),
            params_from_numpy(np_params, "cpu", cfg=cfg))


def frames_of(cfg, b=1, seed=3):
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)


def dec_layer(jp, tp, i=0):
    return ({k: v[i] for k, v in jp["dec"].items()},
            {k: v[i] for k, v in tp["dec"].items()})


# ---------------------------------------------------------------------------
# the config and the wiring
# ---------------------------------------------------------------------------


def test_config_equals_jax_field_by_field():
    jcfg, cfg = jget_config(ARCH), get_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(reduced(cfg)) == \
        dataclasses.asdict(jreduced(jcfg))
    assert (cfg.family, cfg.num_layers, cfg.encoder_layers, cfg.encoder_seq,
            cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
            cfg.d_ff, cfg.vocab_size, cfg.sliding_window) == \
        ("audio", 24, 24, 1500, 1024, 16, 16, 64, 4096, 51865, 8192)
    for c, jc in ((cfg, jcfg), (reduced(cfg), jreduced(jcfg))):
        assert c.param_count() == jc.param_count() == jmodels.param_count(jc)
    assert cfg.param_count() == 758_469_632
    assert models.get_module(cfg) is ted
    assert not getattr(ted, "RING_WRAP_SAFE", False)
    r = reduced(cfg)
    assert (r.num_layers, r.encoder_layers, r.encoder_seq, r.d_model,
            r.num_heads, r.num_kv_heads, r.head_dim) == (2, 2, 64, 256, 8, 8, 32)


@pytest.mark.parametrize("cl", [16, CACHE_LEN])
def test_cache_spec_paged_info_and_init_cache_equal_jax(model, cl):
    jcfg, cfg, _, _ = model
    spec, axes = ted.cache_spec(cfg, 3, cl, torch.bfloat16)
    jspec, jaxes = jed.cache_spec(jcfg, 3, cl, jnp.bfloat16)
    assert axes == jaxes
    assert {k: s for k, (s, _) in spec.items()} == \
        {k: tuple(v.shape) for k, v in jspec.items()}
    assert {k: str(d).split(".")[-1] for k, (_, d) in spec.items()} == \
        {k: str(v.dtype) for k, v in jspec.items()}
    assert ted.paged_info(cfg, cl, 16) == jed.paged_info(jcfg, cl, 16)
    assert ted.paged_info(cfg, cl, 16)["alloc"] == "incremental"
    assert not ted.paged_info(cfg, cl, 16)["prefix_sharing"]
    for kw in ({}, {"kv_dtype": "int8"}, {"kv_dtype": "bf16"},
               {"page_size": 16}, {"page_size": 8, "kv_dtype": "int8",
                                   "num_pages": 9}):
        tc = ted.init_cache(cfg, 2, cl, torch.float32, **kw)
        jc = jed.init_cache(jcfg, 2, cl, jnp.float32, **kw)
        assert {k: tuple(v.shape) for k, v in tc.items()} == \
            {k: tuple(v.shape) for k, v in jc.items()}
        assert {k: str(v.dtype).split(".")[-1] for k, v in tc.items()} == \
            {k: str(v.dtype) for k, v in jc.items()}


# ---------------------------------------------------------------------------
# norms, the MLP and the positions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("eps", [1e-5, 1e-3])
def test_layer_norm_matches_jax(eps):
    rng = np.random.default_rng(11)
    x = (3.0 + 2.0 * rng.standard_normal((2, 7, 256))).astype(np.float32)
    w = (1.0 + 0.1 * rng.standard_normal(256)).astype(np.float32)
    b = (0.1 * rng.standard_normal(256)).astype(np.float32)
    got = cm.layer_norm(t(x), t(w), t(b), eps)
    want = jcm.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), eps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # bf16 in, bf16 out, computed in fp32
    xb = t(x).to(torch.bfloat16)
    assert cm.layer_norm(xb, t(w), t(b)).dtype == torch.bfloat16


def test_gelu_mlp_is_the_tanh_form():
    """gelu_mlp against the JAX one at 1e-5; the erf GELU (torch's
    default) misses that bar on the same inputs."""
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    w_in = (0.5 * rng.standard_normal((64, 128))).astype(np.float32)
    b_in = (0.1 * rng.standard_normal(128)).astype(np.float32)
    w_out = (0.1 * rng.standard_normal((128, 64))).astype(np.float32)
    b_out = (0.1 * rng.standard_normal(64)).astype(np.float32)
    args = (x, w_in, b_in, w_out, b_out)
    want = np.asarray(jcm.gelu_mlp(*map(jnp.asarray, args)))
    got = cm.gelu_mlp(*map(t, args)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    erf = torch.nn.functional.gelu(t(x) @ t(w_in) + t(b_in)) @ t(w_out) \
        + t(b_out)
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(erf.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seq,d", [(64, 256), (1500, 1024), (7, 6)])
def test_sinusoid_matches_jax(seq, d):
    """At 1e-5, or at the rounding of an fp32 angle as large as ``seq``
    (2 ulps of it: the packages' fp32 ``pow`` differ in the last bit),
    whichever is larger: 1.8e-4 at Whisper's 1500 frames."""
    atol = max(1e-5, 2 * seq * 2.0 ** -24)
    np.testing.assert_allclose(ted.sinusoid(seq, d).numpy(),
                               np.asarray(jed.sinusoid(seq, d)),
                               rtol=1e-5, atol=atol)


# ---------------------------------------------------------------------------
# the model against JAX
# ---------------------------------------------------------------------------


def test_encode_and_forward_match_jax_with_random_frames(model):
    """encode and forward on random frames, on both flash backends (the
    plain versions here), within 1e-4."""
    jcfg, cfg, jp, tp = model
    fr = frames_of(cfg, b=2)
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 12))
    jenc = jed.encode(jcfg, jp, jnp.asarray(fr))
    jlog = jed.forward(jcfg, jp, jnp.asarray(toks), jnp.asarray(fr))
    with torch.no_grad():
        for backend in ("ref", None):
            close(ted.encode(cfg, tp, t(fr), backend=backend), jenc,
                  f"encode {backend}")
            close(ted.forward(cfg, tp, t(toks).long(), t(fr),
                              backend=backend), jlog, f"forward {backend}")
    # the frames matter: zero frames give other logits
    with torch.no_grad():
        zero = ted.forward(cfg, tp, t(toks).long(), torch.zeros(t(fr).shape))
    assert not np.allclose(zero.numpy(), np.asarray(jlog), atol=1e-2)


def test_decoder_layer_matches_jax(model):
    """One decoder layer: the output and all four K/V tensors."""
    jcfg, cfg, jp, tp = model
    jlp, tlp = dec_layer(jp, tp, 1)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, cfg.encoder_seq, cfg.d_model)) \
        .astype(np.float32)
    jo, jkv = jed._dec_layer(jcfg, jlp, jnp.asarray(x), jnp.asarray(enc))
    with torch.no_grad():
        to, tkv = ted._dec_layer(cfg, tlp, t(x), t(enc))
    close(to, jo, "layer out")
    for name, a, b in zip(("k", "v", "kx", "vx"), tkv, jkv):
        close(a, b, name)


def test_loss_and_grads_match_jax(model):
    """loss_fn with random frames against jax.value_and_grad: the loss at
    rtol 1e-4, every gradient leaf within 1e-3 in relative norm."""
    jcfg, cfg, jp, tp = model
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 16))
    batch = {"tokens": toks.astype(np.int32), "labels": toks.astype(np.int32),
             "frames": frames_of(cfg, b=2, seed=8)}
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jed.loss_fn(jcfg, p, b), has_aux=True))(
            jp, {k: jnp.asarray(v) for k, v in batch.items()})
    params = jax.tree.map(lambda a: a.detach().clone().requires_grad_(), tp)
    tb = {k: t(v).long() if k != "frames" else t(v) for k, v in batch.items()}
    tl, _ = ted.loss_fn(cfg, params, tb)
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-4)
    flat_t = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda a: a.grad.numpy(), params))
    flat_j = dict(jax.tree_util.tree_leaves_with_path(jg))
    assert len(flat_t) == len(flat_j) == 5 + 15 + 24
    for path, g in flat_t:
        want = np.asarray(flat_j[path])
        rel = np.linalg.norm(g - want) / max(np.linalg.norm(want), 1e-12)
        assert rel <= 1e-3, (path, rel)


@pytest.mark.parametrize("with_frames", [False, True],
                         ids=["zero-frames", "frames"])
def test_prefill_matches_jax(model, with_frames):
    """prefill's logits and all four caches (k, v, xk, xv), with the
    frames the scheduler passes (none: zeros) and with random ones; a
    prompt longer than the cache is rolled as in the JAX package."""
    jcfg, cfg, jp, tp = model
    fr = frames_of(cfg) if with_frames else None
    for n, cl in ((10, CACHE_LEN), (20, 16)):
        toks = np.random.default_rng(n).integers(0, cfg.vocab_size, (1, n))
        jl, jc = J_PREFILL(jcfg, jp, jnp.asarray(toks), cl,
                             None if fr is None else jnp.asarray(fr),
                             cache_dtype=jnp.float32)
        with torch.no_grad():
            tl, tc = ted.prefill(cfg, tp, t(toks).long(), cl,
                                 None if fr is None else t(fr),
                                 cache_dtype=torch.float32)
        close(tl, jl, f"logits {n}")
        assert set(tc) == set(jc) == {"k", "v", "xk", "xv"}
        for key in tc:
            assert tuple(tc[key].shape) == tuple(jc[key].shape)
            close(tc[key], jc[key], f"{key} {n}")


def test_cache_to_kv_dtype_keeps_the_cross_caches_float(model):
    jcfg, cfg, jp, tp = model
    toks = np.asarray([PROMPTS[1]], np.int32)
    _, jrow = J_PREFILL(jcfg, jp, jnp.asarray(toks), CACHE_LEN,
                          cache_dtype=jnp.float32)
    row = {k: t(v) for k, v in jrow.items()}
    assert ted.cache_to_kv_dtype(cfg, row, None) is row
    q8 = ted.cache_to_kv_dtype(cfg, row, "int8")
    jq8 = jed.cache_to_kv_dtype(jcfg, jrow, "int8")
    assert set(q8) == set(jq8)
    for key in ("k", "v", "k_scale", "v_scale"):
        np.testing.assert_array_equal(q8[key].numpy(), np.asarray(jq8[key]))
    assert q8["xk"] is row["xk"] and q8["xv"].dtype == torch.float32
    bf = ted.cache_to_kv_dtype(cfg, row, "bf16")
    assert {v.dtype for v in bf.values()} == {torch.bfloat16}
    with pytest.raises(ValueError, match="kv_dtype"):
        ted.cache_to_kv_dtype(cfg, row, "fp8")


def _lanes(cfg, tp, frames=None):
    """PROMPTS prefilled by the port (B=1 rows), spliced into a 3-lane
    ring cache."""
    lanes = ted.init_cache(cfg, 3, CACHE_LEN, torch.float32)
    with torch.no_grad():
        for i, p in enumerate(PROMPTS):
            fr = None if frames is None else frames[i:i + 1]
            _, row = ted.prefill(cfg, tp, torch.tensor([p]), CACHE_LEN, fr,
                                 cache_dtype=torch.float32)
            for k, c in lanes.items():
                c[:, i] = row[k][:, 0]
    return lanes


def test_decode_step_matches_jax(model):
    """The B=1 decode step from a prefilled row, 4 steps."""
    jcfg, cfg, jp, tp = model
    toks = np.asarray([PROMPTS[1]], np.int32)
    fr = frames_of(cfg)
    _, jc = J_PREFILL(jcfg, jp, jnp.asarray(toks), CACHE_LEN,
                        jnp.asarray(fr), cache_dtype=jnp.float32)
    tc = {k: t(v) for k, v in jc.items()}
    pos = toks.shape[1]
    for step in range(4):
        tok = np.asarray([[31 + step]], np.int32)
        jl, jc = J_DECODE(jcfg, jp, jnp.asarray(tok), jc, pos)
        with torch.no_grad():
            tl, _ = ted.decode_step(cfg, tp, t(tok).long(), tc, pos)
        close(tl, jl, f"step {step}")
        pos += 1
    for key in ("k", "v"):
        close(tc[key], jc[key], key)


def test_decode_step_batch_at_ragged_positions_matches_b1_steps(model):
    """Three lanes at their own positions (random frames a lane): the
    lane-major step against each lane's B=1 step, 4 steps."""
    _, cfg, _, tp = model
    fr = t(frames_of(cfg, b=3, seed=9))
    ring, lanes = _lanes(cfg, tp, fr), _lanes(cfg, tp, fr)
    pos = torch.tensor([len(p) for p in PROMPTS], dtype=torch.int32)
    with torch.no_grad():
        for step in range(4):
            toks = torch.tensor([[11 + step], [12 + step], [13 + step]])
            lg, _ = ted.decode_step_batch(cfg, tp, toks, ring, pos)
            for i in range(3):
                row = {k: c[:, i:i + 1] for k, c in lanes.items()}
                one, _ = ted.decode_step(cfg, tp, toks[i:i + 1], row, pos[i])
                close(lg[i], one[0], f"lane {i}, step {step}")
            pos = pos + 1
    for key in ring:
        close(ring[key], lanes[key], key)


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["fp32", "int8"])
@pytest.mark.parametrize("layout", ["ring", "paged"])
def test_decode_step_batch_matches_jax(model, layout, kv_dtype):
    """decode_step_batch against the JAX one on three ragged lanes, 4
    steps, in the four cache forms: logits and the self-attention
    caches; rows spliced by cache_splice_paged on both sides."""
    jcfg, cfg, jp, tp = model
    kw = {"kv_dtype": kv_dtype}
    if layout == "paged":
        kw.update(page_size=16)
    tcache = ted.init_cache(cfg, 3, CACHE_LEN, torch.float32, **kw)
    jcache = jed.init_cache(jcfg, 3, CACHE_LEN, jnp.float32, **kw)
    fr = frames_of(cfg, b=3, seed=10)
    for i, p in enumerate(PROMPTS):
        _, jrow = J_PREFILL(jcfg, jp, jnp.asarray([p], jnp.int32),
                              CACHE_LEN, jnp.asarray(fr[i:i + 1]),
                              cache_dtype=jnp.float32)
        jrow = jed.cache_to_kv_dtype(jcfg, jrow, kv_dtype)
        trow = {k: t(v) for k, v in jrow.items()}
        if layout == "paged":
            pages = np.arange(1 + 3 * i, 4 + 3 * i, dtype=np.int32)
            jcache = jed.cache_splice_paged(jcfg, jcache, jrow, i,
                                            jnp.asarray(pages), 16)
            ted.cache_splice_paged(cfg, tcache, trow, i, t(pages), 16)
        else:
            jcache = {k: c.at[:, i].set(jrow[k][:, 0])
                      for k, c in jcache.items()}
            for k, c in tcache.items():
                c[:, i] = trow[k][:, 0]
    for key in tcache:
        np.testing.assert_array_equal(tcache[key].numpy(),
                                      np.asarray(jcache[key]), err_msg=key)
    pos = np.asarray([len(p) for p in PROMPTS], np.int32)
    for step in range(4):
        toks = np.asarray([[21 + step], [22 + step], [23 + step]], np.int32)
        jl, jcache = J_DECODE_BATCH(jcfg, jp, jnp.asarray(toks),
                                           jcache, jnp.asarray(pos))
        with torch.no_grad():
            tl, _ = ted.decode_step_batch(cfg, tp, t(toks).long(), tcache,
                                          t(pos))
        close(tl, jl, f"step {step}")
        pos = pos + 1
    for key in tcache:
        if tcache[key].dtype == torch.int8:
            diff = np.abs(tcache[key].numpy().astype(np.int32)
                          - np.asarray(jcache[key]).astype(np.int32))
            assert diff.max() <= 1, key
        else:
            close(tcache[key], jcache[key], key)


# ---------------------------------------------------------------------------
# the scheduler path
# ---------------------------------------------------------------------------

MIX = [[3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8, 9, 7, 9, 3, 2, 3, 8, 4],
       list(range(50, 62)), [2, 7]]
MAX_NEW = 16


def _ragged_run(cls_sched, cls_req, cfg, params, **kw):
    """Two lanes, three requests: lane 0 runs 3 ticks ahead, then two
    more arrive mid-flight (one waits for a lane to retire)."""
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


_JAX_RUNS = {}


def jax_tokens(model, kv_dtype):
    """The JAX scheduler's ring run of MIX with this kv_dtype."""
    if kv_dtype not in _JAX_RUNS:
        jcfg, _, jp, _ = model
        _JAX_RUNS[kv_dtype] = _ragged_run(JSched, JRequest, jcfg, jp,
                                          kv_dtype=kv_dtype)[0]
    return _JAX_RUNS[kv_dtype]


@pytest.mark.parametrize("opts", [
    {}, {"kv_dtype": "int8"}, {"kv_layout": "paged", "page_size": 16},
    {"kv_layout": "paged", "page_size": 16, "kv_dtype": "int8"},
    {"kv_dtype": "bf16"}, {"decode_mode": "vmapped"}],
    ids=["ring", "ring-int8", "paged", "paged-int8", "ring-bf16", "vmapped"])
def test_scheduler_tokens_match_jax(model, opts):
    """Greedy tokens equal the JAX scheduler's ring run with the same
    kv_dtype, with mid-flight admission; paged lanes allocate pages as
    they grow (no prefix sharing: the cross caches are lane state) and
    return every page; one host sync per retired request."""
    _, cfg, _, tp = model
    got, sched = _ragged_run(TSched, TRequest, cfg, tp, **opts)
    assert got == jax_tokens(model, opts.get("kv_dtype"))
    assert sched.host_syncs == len(MIX)
    assert sched.kv_layout == opts.get("kv_layout", "ring")
    xd = torch.bfloat16 if opts.get("kv_dtype") == "bf16" else torch.float32
    assert sched.state["cache"]["xk"].dtype == xd
    if sched.kv_layout == "paged":
        assert sched._alloc_mode == "incremental" and not sched.prefix_sharing
        assert sched.prefix_hits == 0
        sched.audit_pages()


def test_paged_scheduler_matches_jax_paged(model):
    """Against the JAX scheduler's own paged int8 run (page 8)."""
    jcfg, cfg, jp, tp = model
    outs = []
    for sched_cls, req_cls, c, p in ((JSched, JRequest, jcfg, jp),
                                     (TSched, TRequest, cfg, tp)):
        s = sched_cls(c, p, max_slots=2, cache_len=CACHE_LEN,
                      max_new_cap=MAX_NEW, kv_layout="paged", page_size=8,
                      kv_dtype="int8")
        reqs = [req_cls(uid=i, prompt=list(x), max_new_tokens=MAX_NEW)
                for i, x in enumerate(MIX)]
        for r in reqs:
            s.submit(r)
        s.run()
        outs.append([r.output for r in reqs])
    assert outs[0] == outs[1]


@pytest.mark.parametrize("paged", [False, True], ids=["ring", "paged"])
def test_roofline_cross_bytes_and_flops_equal_jax(model, paged):
    """The accountant counts xk/xv as fixed read-only bytes a lane and
    4 H D L S_enc cross-attention flops a token, as the JAX one does
    (not as recurrence state at twice its bytes)."""
    jcfg, cfg, jp, tp = model
    kw = {"page_size": 16} if paged else {}
    jcache = jed.init_cache(jcfg, 4, CACHE_LEN, jnp.float32, **kw)
    tcache = ted.init_cache(cfg, 4, CACHE_LEN, torch.float32, **kw)
    pkw = dict(paged=True, page_size=16, pages_per_lane=3) if paged else {}
    ja = JAccountant(jcfg, jcache, jp, batch=4, hw=JHWSpec.detect(), **pkw)
    ta = RooflineAccountant(cfg, tcache, tp, batch=4, **pkw)
    jd, td = ja.describe(), ta.describe()
    for key in ("slot_groups", "state_bytes_per_token",
                "fixed_bytes_per_token", "write_bytes_per_token",
                "weight_bytes_per_step", "linear_flops_per_token"):
        assert td[key] == jd[key], key
    L, se, kv, d, h = (cfg.num_layers, cfg.encoder_seq, cfg.num_kv_heads,
                       cfg.resolved_head_dim, cfg.num_heads)
    table = 4 * (CACHE_LEN // 16) if paged else 0
    assert td["fixed_bytes_per_token"] == 2 * L * se * kv * d * 4 + table
    assert td["state_bytes_per_token"] == 0
    for valid in (1, 17, CACHE_LEN):
        assert ta.kv_read_bytes(valid) == ja.kv_read_bytes(valid)
        assert ta.token_bytes(valid) == ja.token_bytes(valid)
        assert ta.token_flops(valid) == ja.token_flops(valid)
    assert ta.token_flops(1) - ta.linear_flops_per_token >= 4 * h * d * L * se


# ---------------------------------------------------------------------------
# artifacts across the packages
# ---------------------------------------------------------------------------


def test_artifact_published_by_jax_loads_in_the_port(tmp_path, model):
    """A Whisper artifact published by the JAX store loads in the port
    with the same config and numbers (the nested enc/dec tree through
    ``convert``), and the port's prefill on it gives the JAX logits."""
    jcfg, cfg, jp, tp = model
    jckpt.publish_checkpoint(JStore(tmp_path), "from-jax", jcfg, jp)
    cfg1, tp1, _ = tckpt.load_published(TStore(tmp_path), "from-jax")
    assert cfg1 == cfg
    got = params_to_numpy(tp1)
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_leaves_with_path(got),
            jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray,
                                                             jp))):
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    assert set(tp1) == set(tp) and set(tp1["enc"]) == set(tp["enc"])
    toks = np.asarray([PROMPTS[1]], np.int32)
    jl, _ = J_PREFILL(jcfg, jp, jnp.asarray(toks), CACHE_LEN,
                        cache_dtype=jnp.float32)
    with torch.no_grad():
        tl, _ = ted.prefill(cfg, tp1, t(toks).long(), CACHE_LEN,
                            cache_dtype=torch.float32)
    close(tl, jl, "prefill on the artifact")


def test_serve_and_train_clis_bootstrap_the_reduced_model(tmp_path, capsys):
    """``launch.serve --model whisper-medium`` bootstraps and serves the
    reduced model on the CPU; ``launch.train --arch whisper-medium``
    feeds it zero frames of (batch, encoder_seq, d_model), trains and
    publishes a tree that loads with the config's nested enc/dec shapes."""
    from repro_torch.launch import serve, train
    serve.main(["--store", str(tmp_path / "serve"), "--model", ARCH,
                "--device", "cpu", "--requests", "2", "--max-new", "4",
                "--prompt-len", "8", "--cache-len", "32"])
    assert f"bootstrapped {ARCH}:v1" in capsys.readouterr().out
    losses = train.main(["--arch", ARCH, "--device", "cpu", "--steps", "2",
                         "--batch", "2", "--seq", "16", "--publish",
                         str(tmp_path / "train")])
    assert len(losses) == 2 and np.isfinite(losses).all()
    cfg, params, _ = tckpt.load_published(TStore(tmp_path / "train"), ARCH)
    assert cfg == reduced(get_config(ARCH))
    assert params["enc"]["wq"].shape == (cfg.encoder_layers, cfg.d_model,
                                         cfg.q_dim)
