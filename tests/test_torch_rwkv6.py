"""RWKV-6 parity: the port's WKV scans, model, scheduler path and
artifacts against the JAX package's, on the same numpy inputs.

The reduced rwkv6-3b of both packages (2 layers, d_model 256, 8 heads of
N 32, vocab 1024).  Weights are made once in numpy (zero-initialized
leaves get small random values, so every mixing term is exercised).
Prefill logits and state, 16 teacher-forced decode steps, the forward,
the loss and every gradient leaf agree within 1e-4: both sides compute in
fp32 and differ in summation order only.  Greedy scheduler tokens are
identical.

The WKV functions and B10's plain version (against the Pallas kernel in
interpret mode, as the JAX suite runs it on the CPU) are held to an error
relative to the output's scale, max |got - want| <= tol * max |want|:
their outputs are sums of unit-scale terms that reach ~80 and cancel, so
two fp32 evaluations differ by ~2e-5 in absolute terms even for the token
recurrence.  tol is 1e-5, and 1e-4 for the chunked scan where w = 0
entries are present: w = 0 clamps log w to -59.9, the in-chunk cumsum
reaches |cum| ~ 360, and fp32's spacing there (3e-5) enters every
exponent taken as a difference of two such sums, in both packages.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_map

from repro import models as jmodels
from repro.checkpoint import ckpt as jckpt
from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.core.modelstore import ModelStore as JStore
from repro.kernels import ops as jops
from repro.models import rwkv6 as jrw
from repro.runtime.roofline import HWSpec as JHWSpec
from repro.runtime.roofline import RooflineAccountant as JAccountant
from repro.runtime.scheduler import ContinuousBatchingScheduler as JSched
from repro.runtime.scheduler import Request as JRequest
from repro_torch import models
from repro_torch.checkpoint import ckpt as tckpt
from repro_torch.configs.base import get_config, reduced
from repro_torch.convert import params_to_numpy
from repro_torch.core.modelstore import ModelStore as TStore
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rwkv6_chunk as trw_chunk
from repro_torch.models import rwkv6 as trw
from repro_torch.runtime.roofline import HWSpec, RooflineAccountant
from repro_torch.runtime.scheduler import ContinuousBatchingScheduler as TSched
from repro_torch.runtime.scheduler import Request as TRequest

from test_torch_transformer import both_params, one_torch_thread  # noqa: F401

ARCH = "rwkv6-3b"
TOL = dict(rtol=1e-4, atol=1e-4)


def assert_scaled(got, want, tol, what=""):
    """max |got - want| <= tol * max |want| (the module docstring says
    why the WKV outputs are compared at their scale)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= tol * scale, f"{what}: max err {err} > {tol} * {scale}"


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def model():
    cfg = reduced(get_config(ARCH))
    jp, tp = both_params(cfg)
    return jreduced(jget_config(ARCH)), cfg, jp, tp


# ---------------------------------------------------------------------------
# the WKV functions and B10's plain version
# ---------------------------------------------------------------------------


def wkv_inputs(b, tlen, h, n, *, w_zero, seed):
    """r, k, v ~ N(0, 1) drawn separately (r != k), decays uniform in
    (0, 1) with every third token's set to exactly 0 when ``w_zero``, the
    bonus and an incoming state s0."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, tlen, h, n)).astype(np.float32)
               for _ in range(3))
    w = rng.uniform(0.0, 1.0, (b, tlen, h, n)).astype(np.float32)
    if w_zero:
        w[:, ::3] = 0.0
    u = rng.standard_normal((h, n)).astype(np.float32)
    s0 = rng.standard_normal((b, h, n, n)).astype(np.float32)
    return r, k, v, w, u, s0


@pytest.mark.parametrize("w_zero", [False, True], ids=["w", "w0"])
@pytest.mark.parametrize("with_s0", [False, True], ids=["zero", "s0"])
@pytest.mark.parametrize("tlen,n", [(1, 32), (5, 32), (32, 32), (33, 32),
                                    (48, 32), (33, 64)])
def test_wkv_functions_match_jax(tlen, n, with_s0, w_zero):
    """wkv_chunked, wkv_scan and wkv_step against the JAX functions; from
    a zero state, B10's plain version (the wrapper on CPU tensors)
    against the Pallas kernel.  1e-5 of the output's scale, 1e-4 for the
    chunked forms with w = 0 entries."""
    chunk_tol = 1e-4 if w_zero else 1e-5
    r, k, v, w, u, s0 = wkv_inputs(2, tlen, 2, n, w_zero=w_zero,
                                   seed=tlen + n)
    s0 = s0 if with_s0 else None
    jin = [jnp.asarray(x) for x in (r, k, v, w, u)]
    js0 = None if s0 is None else jnp.asarray(s0)
    tin = [t(x) for x in (r, k, v, w, u)]
    ts0 = None if s0 is None else t(s0)
    for name, jfn, tfn, tol in (
            ("chunked", jrw.wkv_chunked, trw.wkv_chunked, chunk_tol),
            ("scan", jrw.wkv_scan, trw.wkv_scan, 1e-5)):
        jo, js = jfn(*jin, s0=js0)
        to, ts = tfn(*tin, s0=ts0)
        assert_scaled(to, jo, tol, f"{name} out")
        assert_scaled(ts, js, tol, f"{name} state")
    state = np.zeros((2, 2, n, n), np.float32) if s0 is None else s0
    jo, js = jrw.wkv_step(*(x[:, 0] for x in jin[:4]), jin[4],
                          jnp.asarray(state))
    to, ts = trw.wkv_step(*(x[:, 0] for x in tin[:4]), tin[4], t(state))
    assert_scaled(to, jo, 1e-5, "step out")
    assert_scaled(ts, js, 1e-5, "step state")
    if s0 is None:
        jo, js = jops.rwkv6_chunked(*jin, interpret=True)
        tops.reset_launches()
        to, ts = tops.rwkv6_chunked(*tin)
        assert tops.launches()["rwkv6_chunked"] == 0      # the plain version
        assert_scaled(to, jo, chunk_tol, "B10 plain out")
        assert_scaled(ts, js, chunk_tol, "B10 plain state")


def test_chunked_is_the_recurrence_and_named_backends_agree():
    """The chunked scan equals the token recurrence; wkv_named's ref and
    cuda names agree on the CPU (the wrapper takes its plain version)
    and differentiate the plain scan when grad is on."""
    r, k, v, w, u, s0 = (t(x) for x in wkv_inputs(1, 37, 2, 32, w_zero=True,
                                                  seed=3))
    want = tref.rwkv6_ref(r, k, v, w, u)
    for backend in ("ref", "cuda", None):
        got = trw.wkv_named(r, k, v, w, u, backend=backend)
        for g, x in zip(got, want):
            assert_scaled(g, x, 1e-4, f"wkv_named {backend}")
    got = trw.wkv_named(r, k, v, w, u, s0=s0, backend="ref")
    for g, x in zip(got, tref.rwkv6_ref(r, k, v, w, u, s0=s0)):
        assert_scaled(g, x, 1e-4, "wkv_named with s0")
    with pytest.raises(ValueError, match="zero state"):
        trw.wkv_named(r.to("meta"), k, v, w, u, s0=s0, backend="cuda")
    rg = r.clone().requires_grad_()
    out, _ = trw.wkv_named(rg, k, v, w, u, backend="cuda")
    out.sum().backward()
    assert rg.grad is not None and torch.isfinite(rg.grad).all()


# B10's arithmetic on the card, in plain torch: held to the fp64 plain
# version at the card's bar (WKV_TOL: rtol 1e-4, atol 1e-5, with w = 0
# entries too) and to the Pallas kernel in interpret mode at the scaled
# bars above.  T runs through every residue mod 16 (the ragged last chunk).
WKV_TOL = dict(rtol=1e-4, atol=1e-5)


def _emulation_against_fp64_and_pallas(b, tlen, h, n, w_zero, seed):
    r, k, v, w, u, _ = wkv_inputs(b, tlen, h, n, w_zero=w_zero, seed=seed)
    tin = [t(x) for x in (r, k, v, w, u)]
    got_o, got_s = trw_chunk.column_emulation(*tin)
    want_o, want_s = tref.rwkv6_chunked_ref(*(x.double() for x in tin))
    np.testing.assert_allclose(got_o.double().numpy(), want_o.numpy(),
                               **WKV_TOL)
    np.testing.assert_allclose(got_s.double().numpy(), want_s.numpy(),
                               **WKV_TOL)
    jo, js = jops.rwkv6_chunked(*(jnp.asarray(x) for x in (r, k, v, w, u)),
                                interpret=True)
    tol = 1e-4 if w_zero else 1e-5
    assert_scaled(got_o, jo, tol, "emulation out vs Pallas")
    assert_scaled(got_s, js, tol, "emulation state vs Pallas")


@pytest.mark.parametrize("residue", range(16))
def test_column_emulation_every_residue_mod_16(residue):
    """T = 16 + residue: a whole chunk, then a ragged one of every
    length; N 32 in the kernel's two column blocks, w = 0 entries on odd
    residues."""
    _emulation_against_fp64_and_pallas(2, 16 + residue, 2, 32,
                                       w_zero=residue % 2 == 1,
                                       seed=100 + residue)


@pytest.mark.parametrize("tlen,n,w_zero", [(1, 32, False), (5, 64, True),
                                           (48, 64, True), (40, 64, False)])
def test_column_emulation_short_and_n64(tlen, n, w_zero):
    _emulation_against_fp64_and_pallas(1, tlen, 3, n, w_zero=w_zero,
                                       seed=7 * tlen + n)


@pytest.mark.parametrize("n", [32, 64])
def test_column_emulation_does_not_depend_on_the_block(n):
    """The kernel's sums are fixed by N alone: its split into two column
    blocks gives the bits of a whole head in one block, and a lane run
    alone gives the bits it has inside a batch."""
    r, k, v, w, u, _ = wkv_inputs(3, 37, 2, n, w_zero=True, seed=n)
    tin = [t(x) for x in (r, k, v, w, u)]
    runs = [trw_chunk.column_emulation(*tin),
            trw_chunk.column_emulation(*tin, mb=n)]
    for o, s in runs[1:]:
        assert torch.equal(o, runs[0][0]) and torch.equal(s, runs[0][1])
    lone = trw_chunk.column_emulation(*(x[1:2] for x in tin[:4]), tin[4])
    assert torch.equal(lone[0], runs[0][0][1:2])
    assert torch.equal(lone[1], runs[0][1][1:2])


def test_column_emulation_bf16_inputs():
    """bf16 r, k, v, w: fp32 arithmetic, out rounded once to bf16."""
    r, k, v, w, u, _ = wkv_inputs(1, 21, 2, 32, w_zero=False, seed=5)
    tin = [t(x).bfloat16() for x in (r, k, v, w)] + [t(u)]
    got_o, got_s = trw_chunk.column_emulation(*tin)
    want_o, want_s = tref.rwkv6_chunked_ref(
        *(x.double() for x in tin[:4]), tin[4].double())
    assert got_o.dtype == torch.bfloat16 and got_s.dtype == torch.float32
    np.testing.assert_allclose(got_o.double().numpy(), want_o.numpy(),
                               rtol=4e-3, atol=1e-3)
    np.testing.assert_allclose(got_s.double().numpy(), want_s.numpy(),
                               **WKV_TOL)


_F32, _BF16, _F16 = torch.float32, torch.bfloat16, torch.float16


@pytest.mark.parametrize("dtypes,takes", [
    ((_F32,) * 4, True),
    ((_BF16,) * 4, True),
    ((_BF16, _BF16, _BF16, _F32), True),     # a bf16 RWKV-6's decay
    ((_F16,) * 4, False),
    ((_F16, _F16, _F16, _F32), False),
    ((_F32, _BF16, _BF16, _F32), False),     # mixed r, k, v
    ((_BF16, _BF16, _F32, _F32), False),
    ((_F32, _F32, _F32, _BF16), False),      # w neither fp32 nor r's
], ids=["f32", "bf16", "bf16_w32", "f16", "f16_w32", "mixed_r", "mixed_v",
        "f32_wbf16"])
def test_b10_dtype_rule(dtypes, takes):
    """B10 takes r, k, v of one dtype, fp32 or bf16, and w fp32 or in r's
    dtype; everything else is refused by name, on meta tensors too (the
    card's checks)."""
    r, k, v, w = (torch.empty(1, 20, 2, 32, dtype=d, device="meta")
                  for d in dtypes)
    why = trw_chunk.dtype_refusal(r, k, v, w)
    u = torch.empty(2, 32, device="meta")
    if takes:
        assert why is None
        out, state = trw_chunk.rwkv6_chunked(r, k, v, w, u)
        assert out.dtype == r.dtype and state.dtype == torch.float32
        trw_chunk.drop_meta()
    else:
        assert why.startswith("rwkv6_chunked: r, k, v of one dtype, "
                              "float32 or bfloat16, and w float32 or r's "
                              "dtype")
        with pytest.raises(TypeError, match="r, k, v of one dtype"):
            trw_chunk.rwkv6_chunked(r, k, v, w, u)


# a bf16 model against JAX's bf16 model, elementwise on the same input
# layer by layer: each rounds r, k, v, the mixes and the outputs to bf16
# at the same sites, in another order.  Over a whole prefill two bf16
# evaluations part by 1-2.5 % of the logits' scale, each as far from an
# fp32 evaluation of the same bf16 weights, so the whole prefill is held
# at the scale (assert_scaled).
BF16_TOL = dict(rtol=2e-2, atol=3e-2)
BF16_SCALED = 3e-2


@pytest.mark.parametrize("prompt", [[3, 1, 4, 1, 5], list(range(2, 39))],
                         ids=["p5", "p37"])
def test_bf16_prefill_through_b10_with_fp32_decay_matches_jax(
        model, prompt, monkeypatch):
    """A bf16 reduced RWKV-6 prefill on the cuda backend: B10's wrapper
    takes bf16 r, k, v beside the fp32 decay (on CPU tensors it runs its
    plain version).  Each layer's time mix on the same input, output and
    wkv state, matches the JAX package's elementwise; the whole prefill's
    logits and state match at the scale."""
    jcfg, cfg, jp, tp = model
    seen = []
    wrapped = tops.rwkv6_chunked

    def spy(r, k, v, w, u):
        seen.append((r.dtype, k.dtype, v.dtype, w.dtype,
                     trw_chunk.dtype_refusal(r, k, v, w)))
        return wrapped(r, k, v, w, u)

    monkeypatch.setattr(tops, "rwkv6_chunked", spy)
    toks = np.asarray([prompt], np.int32)
    jpb = jax.tree.map(lambda x: x.astype(jnp.bfloat16), jp)
    tpb = tree_map(lambda x: x.to(torch.bfloat16), tp)
    with torch.no_grad():
        x = tpb["embed"][t(toks).long()]
        for l in range(cfg.num_layers):
            tlp = {k: w[l] for k, w in tpb["layers"].items()}
            jlp = jax.tree.map(lambda a: a[l], jpb["layers"])
            xn = trw.cm.rms_norm(x, tlp["ln1"], cfg.norm_eps)
            a, _, wkv = trw.time_mix(cfg, tlp, xn, backend="cuda")
            ja, _, jwkv = jrw.time_mix(
                jcfg, jlp, jnp.asarray(xn.float().numpy()).astype(
                    jnp.bfloat16))
            for what, got, want in (("out", a, ja), ("wkv", wkv, jwkv)):
                np.testing.assert_allclose(
                    got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                    **BF16_TOL, err_msg=f"layer {l} {what}")
            x = x + a
            x = x + trw.channel_mix(
                cfg, tlp, trw.cm.rms_norm(x, tlp["ln2"], cfg.norm_eps))[0]
        tl, tc = trw.prefill(cfg, tpb, t(toks).long(), 32, backend="cuda")
    assert seen == [(_BF16, _BF16, _BF16, _F32, None)] * 2 * cfg.num_layers
    jl, jc = jrw.prefill(jcfg, jpb, jnp.asarray(toks), 32)
    assert tl.dtype == torch.bfloat16
    assert_scaled(tl.float().numpy(), np.asarray(jl.astype(jnp.float32)),
                  BF16_SCALED, "logits")
    for key in ("wkv", "shift_tm", "shift_cm"):
        assert_scaled(tc[key].float().numpy(),
                      np.asarray(jc[key].astype(jnp.float32)), BF16_SCALED,
                      key)


# ---------------------------------------------------------------------------
# the model against JAX
# ---------------------------------------------------------------------------


def test_config_and_param_count_equal_jax():
    jcfg, cfg = jget_config(ARCH), get_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(reduced(cfg)) == \
        dataclasses.asdict(jreduced(jcfg))
    for c, jc in ((cfg, jcfg), (reduced(cfg), jreduced(jcfg))):
        assert c.param_count() == jc.param_count() == \
            jmodels.param_count(jc)
    assert models.get_module(cfg) is trw
    assert cfg.param_count() == 3_099_691_520


@pytest.mark.parametrize("with_state", [False, True], ids=["zero", "state"])
def test_time_mix_and_channel_mix_match_jax(model, with_state):
    jcfg, cfg, jp, tp = model
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 21, cfg.d_model)).astype(np.float32)
    H, N = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    shift = rng.standard_normal((2, cfg.d_model)).astype(np.float32) \
        if with_state else None
    wkv = rng.standard_normal((2, H, N, N)).astype(np.float32) \
        if with_state else None
    jlp = jax.tree.map(lambda a: a[1], jp["layers"])
    tlp = {k: w[1] for k, w in tp["layers"].items()}
    opt = lambda a, f: None if a is None else f(a)
    jo = jrw.time_mix(jcfg, jlp, jnp.asarray(x), opt(shift, jnp.asarray),
                      opt(wkv, jnp.asarray))
    to = trw.time_mix(cfg, tlp, t(x), opt(shift, t), opt(wkv, t))
    for a, b in zip(to, jo):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    jo = jrw.channel_mix(jcfg, jlp, jnp.asarray(x), opt(shift, jnp.asarray))
    to = trw.channel_mix(cfg, tlp, t(x), opt(shift, t))
    for a, b in zip(to, jo):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    # one token: the step forms
    x1 = x[:, 0]
    shift = shift if with_state else np.zeros_like(x1)
    wkv = wkv if with_state else np.zeros((2, H, N, N), np.float32)
    jo = jrw.time_mix_step(jcfg, jlp, jnp.asarray(x1), jnp.asarray(shift),
                           jnp.asarray(wkv))
    to = trw.time_mix_step(cfg, tlp, t(x1), t(shift), t(wkv))
    for a, b in zip(to, jo):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    jo = jrw.channel_mix(jcfg, jlp, jnp.asarray(x1), jnp.asarray(shift))
    to = trw.channel_mix(cfg, tlp, t(x1), t(shift))
    for a, b in zip(to, jo):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


PROMPTS = [[3, 1, 4, 1, 5], [9, 2, 6, 5, 3, 5, 8, 9, 7, 9, 3, 2, 3, 8, 4, 6,
                             2, 6, 4], [7]]


def assert_cache_close(tcache, jcache):
    assert set(tcache) == set(jcache) == {"wkv", "shift_tm", "shift_cm"}
    for key in tcache:
        assert tcache[key].dtype == torch.float32
        np.testing.assert_allclose(tcache[key].numpy(),
                                   np.asarray(jcache[key]), **TOL,
                                   err_msg=key)


@pytest.mark.parametrize("prompt", PROMPTS, ids=["p5", "p19", "p1"])
def test_prefill_and_teacher_forced_decode_match_jax(model, prompt):
    """Prefill logits and all three state leaves, then 16 teacher-forced
    decode steps (logits and state after each), within 1e-4."""
    jcfg, cfg, jp, tp = model
    toks = np.asarray([prompt], np.int32)
    jl, jc = jrw.prefill(jcfg, jp, jnp.asarray(toks), 32,
                         cache_dtype=jnp.float32)
    tl, tc = trw.prefill(cfg, tp, t(toks).long(), 32,
                         cache_dtype=torch.float32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert_cache_close(tc, jc)
    feed = np.random.default_rng(len(prompt)).integers(1, cfg.vocab_size, 16)
    for step, tok in enumerate(feed):
        tk = np.asarray([[tok]], np.int32)
        jl, jc = jrw.decode_step(jcfg, jp, jnp.asarray(tk), jc,
                                 jnp.int32(len(prompt) + step))
        tl, same = trw.decode_step(cfg, tp, t(tk).long(), tc,
                                   len(prompt) + step)
        assert same is tc                        # advanced in place
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert_cache_close(tc, jc)


def test_decode_step_batch_is_decode_step(model):
    """The lane-major step on three lanes equals decode_step on each lane
    alone, on its row views (as the scheduler's vmapped mode runs it)."""
    _, cfg, _, tp = model
    cache = trw.init_cache(cfg, 3, 32, torch.float32)
    for i, p in enumerate(PROMPTS):
        _, row = trw.prefill(cfg, tp, torch.tensor([p]), 32,
                             cache_dtype=torch.float32)
        for key, c in cache.items():
            c[:, i] = row[key][:, 0]
    lanes = {k: c.clone() for k, c in cache.items()}
    toks = torch.tensor([[11], [12], [13]])
    pos = torch.tensor([5, 19, 1], dtype=torch.int32)
    batched, _ = trw.decode_step_batch(cfg, tp, toks, cache, pos)
    for i in range(3):
        row = {k: c[:, i:i + 1] for k, c in lanes.items()}
        one, _ = trw.decode_step(cfg, tp, toks[i:i + 1], row, pos[i])
        np.testing.assert_allclose(batched[i].numpy(), one[0].numpy(), **TOL)
    for key in cache:
        np.testing.assert_allclose(cache[key].numpy(), lanes[key].numpy(),
                                   **TOL)


def _batch(cfg, b=2, s=24, seed=7):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s))
    return toks.astype(np.int32)


def test_forward_loss_and_grads_match_jax(model):
    """The forward on both WKV backends, then the loss and every gradient
    leaf against jax.value_and_grad, within 1e-4 (relative to each leaf's
    largest entry for the gradients)."""
    jcfg, cfg, jp, tp = model
    toks = _batch(cfg)
    jlog = jrw.forward(jcfg, jp, jnp.asarray(toks))
    with torch.no_grad():
        for backend in ("ref", "cuda"):
            tlog = trw.forward(cfg, tp, t(toks).long(), backend=backend)
            np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    batch = {"tokens": toks, "labels": toks}
    (jl, _), jg = jax.value_and_grad(
        lambda p: jrw.loss_fn(jcfg, p, {k: jnp.asarray(v)
                                        for k, v in batch.items()}),
        has_aux=True)(jp)
    params = jax.tree.map(lambda a: a.detach().clone().requires_grad_(), tp)
    tl, _ = trw.loss_fn(cfg, params, {k: t(v).long() for k, v in batch.items()})
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-4)
    flat_t = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda a: a.grad.numpy(), params))
    flat_j = dict(jax.tree_util.tree_leaves_with_path(jg))
    assert len(flat_t) == len(flat_j) == 25
    for path, g in flat_t:
        want = np.asarray(flat_j[path])
        scale = max(float(np.abs(want).max()), 1e-12)
        np.testing.assert_allclose(g / scale, want / scale, rtol=1e-4,
                                   atol=1e-4, err_msg=str(path))


# ---------------------------------------------------------------------------
# the scheduler path
# ---------------------------------------------------------------------------

MIX = [[3, 1, 4, 1, 5], [2, 7], [9, 8, 7, 6]]


def _ragged_run(cls_sched, cls_req, cfg, params, **kw):
    """The mix of test_batched_decode_token_identical_to_vmapped: lane 0
    runs 3 ticks ahead, so the lanes sit at ragged positions."""
    reqs = [cls_req(uid=i, prompt=list(p), max_new_tokens=6)
            for i, p in enumerate(MIX)]
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


@pytest.fixture(scope="module")
def jax_tokens(model):
    jcfg, _, jp, _ = model
    return _ragged_run(JSched, JRequest, jcfg, jp)[0]


@pytest.mark.parametrize("opts", [
    {}, {"decode_mode": "vmapped"}, {"kv_dtype": "bf16"},
    {"kv_dtype": "int8"}, {"kv_layout": "paged", "page_size": 16}],
    ids=["batched", "vmapped", "bf16", "int8", "paged"])
def test_scheduler_tokens_match_jax(model, jax_tokens, opts):
    """Greedy tokens equal the JAX scheduler's in both decode modes; the
    kv_dtype options leave the fp32 state as it is (a no-op, as in the
    JAX package) and a paged request keeps the ring layout."""
    _, cfg, _, tp = model
    got, sched = _ragged_run(TSched, TRequest, cfg, tp, **opts)
    assert got == jax_tokens
    assert sched.kv_layout == "ring" and sched.free_slots().pages is None
    assert {k: c.dtype for k, c in sched.state["cache"].items()} == {
        "wkv": torch.float32, "shift_tm": torch.float32,
        "shift_cm": torch.float32}
    assert sched.host_syncs == len(MIX)


def test_kv_dtype_is_a_noop_for_the_state(model):
    """Teacher-forced logits with the int8 and the bf16 conversion of one
    prefilled state: the delta is exactly 0 (the state passes through)."""
    _, cfg, _, tp = model
    _, row = trw.prefill(cfg, tp, torch.tensor([PROMPTS[1]]), 32,
                         cache_dtype=torch.float32)
    caches = {d: {k: c.clone() for k, c in
                  trw.cache_to_kv_dtype(cfg, row, d).items()}
              for d in ("bf16", "int8")}
    assert trw.cache_to_kv_dtype(cfg, row, "int8") is row
    for tok in (5, 9, 2, 8):
        lg = {d: trw.decode_step_batch(cfg, tp, torch.tensor([[tok]]), c,
                                       torch.tensor([0]))[0]
              for d, c in caches.items()}
        assert float((lg["int8"] - lg["bf16"]).abs().max()) == 0.0


def test_wrap_guard_skipped_and_long_streams_match_jax(model):
    """No KV ring: a prompt plus generation longer than cache_len is
    accepted (the wrap guard is skipped) and gives the JAX tokens."""
    jcfg, cfg, jp, tp = model
    assert trw.RING_WRAP_SAFE and jrw.RING_WRAP_SAFE
    prompt = list(np.random.default_rng(9).integers(1, 1000, 12))
    outs = []
    for sched_cls, req_cls, c, p in ((JSched, JRequest, jcfg, jp),
                                     (TSched, TRequest, cfg, tp)):
        s = sched_cls(c, p, max_slots=1, cache_len=16, max_new_cap=12)
        req = req_cls(uid=0, prompt=prompt, max_new_tokens=12)
        s.submit(req)
        s.run()
        outs.append(req.output)
    assert outs[0] == outs[1] and len(outs[1]) == 12


def test_state_bytes_per_token_equal_jax(model):
    """The port's roofline accountant classifies the three state leaves
    as recurrence state, like the JAX one, with the same bytes; it takes
    its peaks from the device the cache lies on and refuses a cache on
    two devices."""
    jcfg, cfg, jp, tp = model
    jcache = jrw.init_cache(jcfg, 4, 64, jnp.float32)
    tcache = trw.init_cache(cfg, 4, 64, torch.float32)
    ja = JAccountant(jcfg, jcache, jp, batch=4, hw=JHWSpec.detect())
    ta = RooflineAccountant(cfg, tcache, tp, batch=4)
    for key in ("state_bytes_per_token", "fixed_bytes_per_token",
                "write_bytes_per_token", "weight_bytes_per_step",
                "linear_flops_per_token"):
        assert ta.describe()[key] == ja.describe()[key], key
    assert ta.describe()["state_bytes_per_token"] == 2 * 4 * (
        2 * (8 * 32 * 32 + 2 * 256))
    assert ta.hw == HWSpec.detect("cpu")
    with pytest.raises(TypeError):
        HWSpec.detect()                          # no default device
    mixed = {**tcache, "wkv": tcache["wkv"].to("meta")}
    with pytest.raises(ValueError, match="one device"):
        RooflineAccountant(cfg, mixed, tp, batch=4)


# ---------------------------------------------------------------------------
# artifacts across the packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
def test_artifacts_cross_the_store_both_ways(tmp_path, model, int8):
    """An RWKV-6 artifact published by either package loads in the other
    with the same config and numbers, and the port's prefill on it gives
    the JAX package's logits."""
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
    jl, _ = jrw.prefill(jcfg, jax.tree.map(jnp.asarray, got_t),
                        jnp.asarray(toks), 32, cache_dtype=jnp.float32)
    tl, _ = trw.prefill(cfg, tp1, t(toks).long(), 32,
                        cache_dtype=torch.float32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
