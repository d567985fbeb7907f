"""Training parity: the port's loss, gradients, optimizer, data, train
step, train-state files and trainer CLI against the JAX package's, on
the same numpy weights and batches, on the CPU.

The reduced TinyLlama (GQA 8:1) and Qwen3 (qk-norm, tied embeddings)
configs, 2 layers at d_model 256.  Attention runs on the ``ref`` backend
(``attention_chunked``) and on the ``cuda`` backend's CPU path, which is
B9's autograd Function over the plain FA-2 pieces, inside the per-layer
``torch.utils.checkpoint``.  The port's trainer is held to step-by-step
equality with the JAX trainer, not to the JAX suite's learning bar (a
loss drop of 0.2 within 25 steps, which the reference itself misses).

Tolerances, each stated at its use: loss and gradients rtol 1e-4 /
atol 1e-6 (fp32, summation order only); one AdamW update rtol 1e-6
(elementwise fp32 arithmetic in the reference's order); the cosine
schedule rtol 1e-6; batches bit-equal; three train steps' losses
rtol 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.core.modelstore import ModelStore as JStore
from repro.data import pipeline as jdata
from repro.launch import train as jtrain
from repro.models import common as jcm
from repro.models import transformer as jtf
from repro.optim import adamw as jadamw
from repro_torch import models
from repro_torch.checkpoint import ckpt as tckpt
from repro_torch.configs.base import get_config, reduced
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.data import pipeline as tdata
from repro_torch.kernels import ops as kops
from repro_torch.launch import train as ttrain
from repro_torch.models import common as tcm
from repro_torch.models import transformer as ttf
from repro_torch.optim import adamw as tadamw

from conftest import assert_close
from test_torch_transformer import numpy_params, one_torch_thread  # noqa: F401

ARCHS = ["tinyllama-1.1b", "qwen3-0.6b"]
LOSS_TOL = dict(rtol=1e-4, atol=1e-6)


def t(a):
    return torch.from_numpy(np.array(a))


def batch_of(cfg, b=2, s=32, seed=0):
    return tdata.SyntheticLM(tdata.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=s, global_batch=b,
        seed=seed)).batch(0)


def leaves(tree, prefix=""):
    """(path, array) pairs of a nested dict, sorted."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, np.asarray(v)


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    cfg = reduced(get_config(request.param))
    jcfg = jreduced(jget_config(request.param))
    return jcfg, cfg, numpy_params(cfg)


# ---------------------------------------------------------------------------
# the loss and its gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True])
def test_softmax_xent_matches_jax(masked):
    rng = np.random.default_rng(0)
    logits = (3 * rng.standard_normal((2, 7, 50))).astype(np.float32)
    labels = rng.integers(0, 50, (2, 7)).astype(np.int32)
    mask = (rng.random((2, 7)) < 0.6).astype(np.float32) if masked else None
    want = jcm.softmax_xent(jnp.asarray(logits), jnp.asarray(labels),
                            None if mask is None else jnp.asarray(mask))
    got = tcm.softmax_xent(t(logits), t(labels),
                           None if mask is None else t(mask))
    assert_close(got, want, rtol=1e-6, atol=1e-6)
    if masked:            # an all-zero mask divides by 1, as the reference
        zero = tcm.softmax_xent(t(logits), t(labels), torch.zeros(2, 7))
        assert float(zero) == 0.0


@pytest.mark.parametrize("backend", ["ref", "cuda"])
def test_loss_and_grads_match_jax(arch, backend):
    """loss_fn and the gradient of every leaf against jax.value_and_grad
    (rtol 1e-4, atol 1e-6); ``cuda`` on CPU tensors is B9's Function on
    the plain pieces, recomputed under the per-layer checkpoint."""
    jcfg, cfg, np_params = arch
    batch = batch_of(cfg)
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jtf.loss_fn(jcfg, p, {k: jnp.asarray(v)
                                        for k, v in batch.items()}),
        has_aux=True)(jax.tree.map(jnp.asarray, np_params))
    params = params_from_numpy(np_params, "cpu", cfg=cfg)
    flat = [p.requires_grad_() for _, p in tadamw.tree_items(params)]
    loss, metrics = models.get_module(cfg).loss_fn(
        cfg, params, tdata.to_device(batch, "cpu"), backend=backend)
    grads = torch.autograd.grad(loss, flat)
    assert_close(loss.detach(), jloss, **LOSS_TOL)
    assert metrics["loss"] is loss
    want = dict(leaves(jax.tree.map(np.asarray, jgrads)))
    got = [path for path, _ in leaves(np_params)]
    assert got == sorted(want)
    for path, g in zip(got, grads):
        assert_close(g, want[path], **LOSS_TOL, err_msg=path)


def test_remat_changes_nothing_but_memory(arch):
    _, cfg, np_params = arch
    tokens = t(batch_of(cfg)["tokens"]).long()
    params = params_from_numpy(np_params, "cpu", cfg=cfg)
    flat = [p.requires_grad_() for _, p in tadamw.tree_items(params)]
    outs = []
    for remat in (True, False):
        logits = ttf.forward(cfg, params, tokens, remat=remat)
        outs.append((logits.detach(),
                     torch.autograd.grad(logits.square().mean(), flat)))
    assert torch.equal(outs[0][0], outs[1][0])
    for a, b in zip(outs[0][1], outs[1][1]):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# AdamW, the schedule, the data
# ---------------------------------------------------------------------------


def test_adamw_update_matches_jax():
    """One update from a state with nonzero moments, clipping active and
    the schedule's lr (rtol 1e-6)."""
    rng = np.random.default_rng(1)
    tree = lambda s: {"a": (s * rng.standard_normal((5, 4))).astype(np.float32),
                      "b": {"c": (s * rng.standard_normal(7)).astype(np.float32)}}
    params, grads, m, v = tree(1.0), tree(3.0), tree(0.1), tree(0.1)
    v = jax.tree.map(np.abs, v)
    sched_kw = dict(peak=1e-2, warmup=2, total=10)
    jopt = jadamw.AdamW(lr=jadamw.cosine_schedule(**sched_kw))
    topt = tadamw.AdamW(lr=tadamw.cosine_schedule(**sched_kw))
    jp, jst, jm = jopt.update(
        jax.tree.map(jnp.asarray, grads),
        jadamw.AdamWState(jnp.asarray(2, jnp.int32),
                          jax.tree.map(jnp.asarray, m),
                          jax.tree.map(jnp.asarray, v)),
        jax.tree.map(jnp.asarray, params))
    tt = lambda x: tadamw.tree_map(lambda a: t(a), x)
    tp, tst, tm = topt.update(tt(grads),
                              tadamw.AdamWState(torch.tensor(2, dtype=torch.int32),
                                                tt(m), tt(v)),
                              tt(params))
    assert int(tst.step) == int(jst.step) == 3
    for got, want in ((tp, jp), (tst.m, jst.m), (tst.v, jst.v)):
        for (pa, a), (pb, b) in zip(leaves(params_to_numpy(got)),
                                    leaves(jax.tree.map(np.asarray, want))):
            assert pa == pb
            assert_close(a, b, rtol=1e-6, atol=1e-9, err_msg=pa)
    assert float(tm["grad_norm"]) > 1.0                 # the clip was active
    for k in ("grad_norm", "lr"):
        assert isinstance(tm[k], torch.Tensor)
        assert_close(tm[k], jm[k], rtol=1e-6)


def test_adamw_init_and_constant_lr():
    opt = tadamw.AdamW(lr=1e-3, weight_decay=0.0, grad_clip=0.0)
    params = {"w": torch.ones(3)}
    st = opt.init(params)
    assert st.step.dtype == torch.int32 and int(st.step) == 0
    assert st.m["w"].dtype == torch.float32 and not st.m["w"].any()
    p, st, m = opt.update({"w": torch.full((3,), 2.0)}, st, params)
    assert p is params and float(m["lr"]) == pytest.approx(1e-3)
    # first step: m_hat / sqrt(v_hat) = sign(g)
    assert_close(p["w"], np.full(3, 1 - 1e-3, np.float32), rtol=1e-6)


def test_cosine_schedule_matches_jax():
    steps = np.arange(0, 40, dtype=np.int32)
    want = jadamw.cosine_schedule(3e-4, 10, 30)(jnp.asarray(steps))
    got = tadamw.cosine_schedule(3e-4, 10, 30)(t(steps))
    assert_close(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("seed,step", [(0, 0), (0, 5), (3, 1)])
def test_synthetic_batches_are_bit_equal(seed, step):
    cfg = dict(vocab_size=1000, seq_len=33, global_batch=3, seed=seed)
    want = jdata.SyntheticLM(jdata.DataConfig(**cfg)).batch(step)
    got = tdata.SyntheticLM(tdata.DataConfig(**cfg)).batch(step)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    dev = tdata.to_device(got, "cpu")
    assert dev["tokens"].dtype == torch.int64
    np.testing.assert_array_equal(dev["tokens"].numpy(), want["tokens"])


def test_byte_tokenizer_matches_jax():
    text = "train once, reuse everywhere — é"
    jt, tt = jdata.ByteTokenizer(), tdata.ByteTokenizer()
    assert tt.encode(text) == jt.encode(text)
    assert tt.decode(tt.encode(text)) == jt.decode(jt.encode(text)) == text


# ---------------------------------------------------------------------------
# the train step, the train-state files, the CLI
# ---------------------------------------------------------------------------


def test_three_train_steps_match_jax(arch):
    """make_train_step in both packages from one numpy tree, on the same
    batches: losses within rtol 1e-4 at every step."""
    jcfg, cfg, np_params = arch
    sched = dict(peak=1e-3, warmup=1, total=3)
    jstep = jtrain.make_train_step(
        jcfg, jadamw.AdamW(lr=jadamw.cosine_schedule(**sched)))
    topt = tadamw.AdamW(lr=tadamw.cosine_schedule(**sched))
    tstep = ttrain.make_train_step(cfg, topt)
    jp = jax.tree.map(jnp.asarray, np_params)
    jst = jadamw.AdamW().init(jp)
    tp = tadamw.tree_map(lambda p: p.requires_grad_(),
                         params_from_numpy(np_params, "cpu", cfg=cfg))
    tst = topt.init(tp)
    data = tdata.SyntheticLM(tdata.DataConfig(vocab_size=cfg.vocab_size,
                                              seq_len=32, global_batch=2))
    for step in range(3):
        raw = data.batch(step)
        jp, jst, jm = jstep(jp, jst, {k: jnp.asarray(v)
                                      for k, v in raw.items()})
        tp, tst, tm = tstep(tp, tst, tdata.to_device(raw, "cpu"))
        assert_close(float(tm["loss"]), float(jm["loss"]), rtol=1e-4,
                     atol=0, err_msg=f"step {step}")
        assert_close(tm["grad_norm"], jm["grad_norm"], rtol=1e-4)


def test_train_state_round_trips_across_packages(tmp_path, arch):
    jcfg, cfg, np_params = arch
    jopt, topt = jadamw.AdamW(), tadamw.AdamW()
    tp = params_from_numpy(np_params, "cpu", cfg=cfg)
    tst = topt.init(tp)
    tst = tst._replace(step=torch.tensor(7, dtype=torch.int32),
                       m=tadamw.tree_map(lambda x: x + 0.5, tst.m))
    tckpt.save_train_state(tmp_path / "t", tp, tst, {"from": "torch"})
    jp, jst, meta = jckpt.restore_train_state(tmp_path / "t")
    assert meta == {"from": "torch"} and int(jst.step) == 7
    for (pa, a), (pb, b) in zip(leaves(np_params),
                                leaves(jax.tree.map(np.asarray, jp))):
        assert pa == pb
        np.testing.assert_array_equal(a, b)
    assert float(np.asarray(jst.m["embed"]).min()) == 0.5

    jckpt.save_train_state(tmp_path / "j", jax.tree.map(jnp.asarray, np_params),
                           jopt.init(jax.tree.map(jnp.asarray, np_params)))
    tp2, tst2, meta2 = tckpt.restore_train_state(tmp_path / "j")
    assert meta2 == {} and int(tst2.step) == 0
    assert tst2.step.dtype == torch.int32
    for (pa, a), (pb, b) in zip(leaves(np_params),
                                leaves(params_to_numpy(tp2))):
        assert pa == pb
        np.testing.assert_array_equal(a, b)
    assert set(tst2.v) == set(np_params)
    _, none, _ = tckpt.restore_train_state(
        tckpt.save_train_state(tmp_path / "p", tp))
    assert none is None


def test_train_cli_publishes_what_jax_loads(tmp_path, capsys):
    ttrain.main(["--device", "cpu", "--steps", "2", "--batch", "2",
                 "--seq", "32", "--publish", str(tmp_path)])
    out = capsys.readouterr().out
    assert "published tinyllama-1.1b:v1" in out
    jcfg, jp, rec = jckpt.load_published(JStore(tmp_path), "tinyllama-1.1b")
    cfg = reduced(get_config("tinyllama-1.1b"))
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    assert rec.load_spec()["metadata"]["steps"] == 2
    assert np.isfinite(np.asarray(jp["layers"]["wq"])).all()


def test_train_from_numpy_matches_jax_trainer_losses(arch):
    """train() from one numpy tree against the JAX trainer's step
    function on the same schedule and batches (rtol 1e-4)."""
    jcfg, cfg, np_params = arch
    steps, kw = 2, dict(batch=2, seq=32, lr=1e-3, warmup=1)
    _, losses = ttrain.train(cfg.name, steps=steps, device="cpu",
                             params=np_params, log_every=100, **kw)
    jopt = jadamw.AdamW(lr=jadamw.cosine_schedule(kw["lr"], kw["warmup"],
                                                  steps))
    jstep = jtrain.make_train_step(jcfg, jopt)
    jp = jax.tree.map(jnp.asarray, np_params)
    jst = jopt.init(jp)
    data = jdata.SyntheticLM(jdata.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=kw["seq"],
        global_batch=kw["batch"], seed=0))
    for step in range(steps):
        jp, jst, jm = jstep(jp, jst, {k: jnp.asarray(v) for k, v in
                                      data.batch(step).items()})
        assert losses[step] == pytest.approx(float(jm["loss"]), rel=1e-4)


def test_train_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.train("tinyllama-1.1b", steps=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(["--steps", "1"])


def test_prefill_ref_backend_is_unchanged(arch):
    """prefill on the ``ref`` backend (and on auto, which is ref on the
    CPU) gives the JAX prefill's logits and caches (rtol 1e-4, atol
    1e-5), and launches nothing."""
    jcfg, cfg, np_params = arch
    tokens = np.array([[3, 1, 4, 1, 5, 9, 2, 6, 5]], np.int32)
    jl, jc = jtf.prefill(jcfg, jax.tree.map(jnp.asarray, np_params),
                         jnp.asarray(tokens), 16, cache_dtype=jnp.float32)
    params = params_from_numpy(np_params, "cpu", cfg=cfg)
    kops.reset_launches()
    with torch.inference_mode():
        for backend in ("ref", None):
            tl, tc = ttf.prefill(cfg, params, t(tokens).long(), 16,
                                 cache_dtype=torch.float32, backend=backend)
            assert_close(tl, jl, rtol=1e-4, atol=1e-5)
            for key in ("k", "v"):
                assert_close(tc[key], jc[key], rtol=1e-4, atol=1e-5)
    assert kops.launches() == {n: 0 for n in kops.KERNELS}
