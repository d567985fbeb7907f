"""The port's sharded paths on a CPU mesh against the JAX package's
single-device results.

Four gloo ranks (``tests/torch_mesh_worker.py``, in subprocesses that
import no JAX) run the port on two meshes of one world: (data=2,
model=2) and (data=1, model=4).  On (2,2): reduced Qwen3-MoE and
Granite-MoE (capacity factor 8, so no path drops a token) through
``moe_impl`` 'dense', 'a2a' and 'local', logits within 1e-4 of JAX's
forward; the dense body at capacity factor 0.5, where JAX drops
entries, on Qwen3-MoE (2,2) (its buffer split by experts), Granite-MoE
with 6 experts on (1,4) and 3 on (2,2) (split by capacity rows), each
with the weights kept split over the data axis (few tokens), gathered
(4 x 512 tokens) or routed alike by both data ranks (a batch of 1):
logits and the global aux against JAX's, and its refusal of a rule
that splits seq; and the sharded train step (``launch.dryrun.build_step``) of
reduced TinyLlama (8 q heads split over the model axis, its one kv head
replicated), loss within 1e-4 relative and every gradient within 1e-3
relative norm of ``jax.value_and_grad``.  On (1,4): the same train step
for reduced Llama3-8B, 8 q heads split four ways and 2 kv heads
replicated, so each rank's two q heads meet the kv head of their group.
The same train step, with drops, for reduced Qwen3-MoE on (2,2) and
Granite-MoE (6 experts) on (1,4): the base rules' dense body; and in
its other forms (``DENSE_TRAIN_CASES``).
On (2,2) the sharded prefill step of reduced TinyLlama and
RecurrentGemma (fp32 weights, the caches in bf16): logits and every
cache leaf against the port's unsharded prefill and JAX's, each leaf in
its ``cache_spec`` placement and dtype.  On (2,2) and (1,4) the
vocab-split loss (``softmax_xent`` on DTensor logits, each rank on its
own vocab shard), unmasked and masked, and its gradient against the
unsharded loss and ``jax.grad`` of JAX's.
Two bodies are held to the port's own unsharded functions instead (the
JAX dry run rejects the mesh's axes): on (2,2) the RG-LRU's ``_log_a``
(lam split on ``tp_ff``) and its gradients, and on (2,2) and (1,4)
reduced Whisper's ``decode_step`` on a 'bskd' self-attention ring split
on its slots (two steps, the second past the wrap) beside a cross cache
split on batch.  Weights are made once in numpy.
"""
import dataclasses
import os
import subprocess
import sys
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro import models as jmodels
import torch

from repro_torch.configs.base import get_config, reduced
from repro_torch.convert import params_from_numpy

from conftest import assert_close
from test_torch_encdec import numpy_params as any_family_params
from test_torch_transformer import numpy_params

WORLD = 4
MOE_ARCHS = ["qwen3-moe-235b-a22b", "granite-moe-3b-a800m"]
# the dense body where it drops entries (capacity factor 0.5): (arch,
# model axis, config fields, tokens, the buffer's split, the expert
# products' form).  Qwen3-MoE's 4 experts split over the model axis; 6
# experts on 4 and 3 on 2 split by capacity rows, padded (the model axis
# does not divide them).  A few tokens a layer keep the weights split
# over the data axis and contract d there ('contract'); 4 x 512 tokens
# gather them ('gather'); a batch of 1, which the data axis does not
# split, has both data ranks route the same tokens
DENSE_CASES = {
    "qwen_drops": ("qwen3-moe-235b-a22b", 2, {"capacity_factor": 0.5},
                   (4, 16), "experts", "contract"),
    "granite_e6_rows": ("granite-moe-3b-a800m", 4,
                        {"capacity_factor": 0.5, "num_experts": 6},
                        (4, 16), "rows", "contract"),
    "granite_e3_rows": ("granite-moe-3b-a800m", 2,
                        {"capacity_factor": 0.5, "num_experts": 3},
                        (4, 16), "rows", "contract"),
    "qwen_gather": ("qwen3-moe-235b-a22b", 2, {"capacity_factor": 0.5},
                    (4, 512), "experts", "gather"),
    "granite_e3_gather": ("granite-moe-3b-a800m", 2,
                          {"capacity_factor": 0.5, "num_experts": 3},
                          (4, 512), "rows", "gather"),
    "qwen_batch1": ("qwen3-moe-235b-a22b", 2, {"capacity_factor": 0.5},
                    (1, 64), "experts", "contract"),
    "granite_e3_batch1": ("granite-moe-3b-a800m", 2,
                          {"capacity_factor": 0.5, "num_experts": 3},
                          (1, 64), "rows", "contract"),
}
AUX_RTOL = 1e-5
TRAIN_CASES = [("tinyllama-1.1b", 2), ("llama3-8b", 4),
               ("qwen3-moe-235b-a22b", 2), ("granite-moe-3b-a800m", 4)]
# the MoE train steps take the base rules' dense body with drops, the
# second on its capacity-row route
TRAIN_CFG = {"qwen3-moe-235b-a22b": {"capacity_factor": 0.5},
             "granite-moe-3b-a800m": {"capacity_factor": 0.5,
                                      "num_experts": 6}}
# more train steps through the dense body, each a DENSE_CASES entry's
# arch, mesh and config: the other forms of the expert products and the
# capacity-row route on a data axis of 2 (tokens as TRAIN_CASES' unless
# given)
DENSE_TRAIN_CASES = {"qwen_gather": (8, 256), "qwen_batch1": (1, 64),
                     "granite_e3_rows": (4, 32),
                     "granite_e3_gather": (4, 256)}
LOGIT_TOL = dict(rtol=1e-4, atol=1e-5)
LOSS_RTOL = 1e-4
GRAD_REL = 1e-3
# the sharded bodies against the port's unsharded functions: the same
# fp32 products, summed in another order (the slot split's merge)
BODY_TOL = dict(rtol=1e-5, atol=1e-6)
# values that are sums of many O(1) products taken in another order (a
# weight's gradient over the split batch, then across the ranks; layer
# 1's k/v, a 256-term product of layer 0's output): a few fp32 ulps of 10
SUM_TOL = dict(rtol=1e-5, atol=1e-5)
DECODE_MESHES = [2, 4]
PREFILL_ARCHS = ["tinyllama-1.1b", "recurrentgemma-9b"]
XENT_MESHES = [2, 4]
# a cache leaf stored in bf16: the fp32 values it rounds differ in the
# last fp32 bits between the runs, which can move a rounding by one bf16
# step (2^-8 relative)
BF16_CACHE_TOL = dict(rtol=2 ** -7, atol=1e-6)
# the loss (a mean of B * S logsumexps) and its gradient (softmax minus
# one-hot, over B * S) in another summation order
XENT_TOL = dict(rtol=1e-5, atol=1e-9)
DECODE_POSITIONS = [5, 21]           # the second wraps the 16-slot ring
WORKER = pathlib.Path(__file__).with_name("torch_mesh_worker.py")


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flat(v, key + "/"))
        else:
            out[key] = v
    return out


def _cfgs(arch, **over):
    return (dataclasses.replace(jreduced(jget_config(arch)), **over),
            dataclasses.replace(reduced(get_config(arch)), **over))


def _log_a_inputs(cfg, seed):
    rng = np.random.default_rng(seed)
    shape = (4, 8, cfg.lru_width)
    return {k: rng.standard_normal(shape).astype(np.float32)
            for k in ("x", "c_a", "c_i")}


def _decode_inputs(cfg, seed, b=2, s=16):
    rng = np.random.default_rng(seed)
    L, kv, hd = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim
    out = {k: rng.standard_normal((L, b, n, kv, hd)).astype(np.float32)
           for k, n in (("k", s), ("v", s), ("xk", cfg.encoder_seq),
                        ("xv", cfg.encoder_seq))}
    out["token"] = rng.integers(0, cfg.vocab_size,
                                (len(DECODE_POSITIONS), b, 1))
    return out


def _xent_inputs(seed, b=4, s=6, v=64):
    rng = np.random.default_rng(seed)
    return {"logits": (3 * rng.standard_normal((b, s, v))).astype(np.float32),
            "labels": rng.integers(0, v, (b, s)).astype(np.int64),
            "mask": (rng.random((b, s)) < 0.7).astype(np.float32)}


def _tokens(cfg, shape, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, shape).astype(np.int32)


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    """Writes the job, runs the four ranks once, returns (job, outputs)."""
    io = tmp_path_factory.mktemp("mesh")
    cases, ref = [], {}
    for i, arch in enumerate(MOE_ARCHS):
        jcfg, cfg = _cfgs(arch, capacity_factor=8.0)
        w = numpy_params(cfg, seed=i)
        tok = _tokens(cfg, (4, 16), seed=10 + i)
        name = f"moe_{arch}"
        np.savez(io / f"{name}_w.npz", **_flat(w))
        np.save(io / f"{name}_tok.npy", tok)
        cases.append({"name": name, "kind": "moe", "arch": arch,
                      "cfg": {"capacity_factor": 8.0}, "model_axis": 2,
                      "weights": f"{name}_w.npz",
                      "tokens": f"{name}_tok.npy"})
        ref[name] = (jcfg, w, tok)
    for i, (name, (arch, m, over, shape, *_)) in enumerate(sorted(
            DENSE_CASES.items())):
        jcfg, cfg = _cfgs(arch, **over)
        w = numpy_params(cfg, seed=90 + i)
        tok = _tokens(cfg, shape, seed=100 + i)
        np.savez(io / f"{name}_w.npz", **_flat(w))
        np.save(io / f"{name}_tok.npy", tok)
        cases.append({"name": name, "kind": "moe", "arch": arch,
                      "cfg": over, "model_axis": m, "impls": ["dense"],
                      "seq_guard": name == "qwen_drops",
                      "weights": f"{name}_w.npz",
                      "tokens": f"{name}_tok.npy"})
        ref[name] = (jcfg, w, tok)
    for i, (arch, m) in enumerate(TRAIN_CASES):
        over = TRAIN_CFG.get(arch, {})
        jcfg, cfg = _cfgs(arch, **over)
        w = numpy_params(cfg, seed=20 + i)
        tok = _tokens(cfg, (4, 32), seed=30 + i)
        name = f"train_{arch}"
        np.savez(io / f"{name}_w.npz", **_flat(w))
        np.save(io / f"{name}_tok.npy", tok)
        cases.append({"name": name, "kind": "train", "arch": arch,
                      "cfg": over, "model_axis": m,
                      "weights": f"{name}_w.npz",
                      "tokens": f"{name}_tok.npy"})
        ref[name] = (jcfg, w, tok)
    for i, (case, shape) in enumerate(sorted(DENSE_TRAIN_CASES.items())):
        arch, m, over = DENSE_CASES[case][:3]
        jcfg, cfg = _cfgs(arch, **over)
        w = numpy_params(cfg, seed=110 + i)
        tok = _tokens(cfg, shape, seed=120 + i)
        name = f"train_dense_{case}"
        np.savez(io / f"{name}_w.npz", **_flat(w))
        np.save(io / f"{name}_tok.npy", tok)
        cases.append({"name": name, "kind": "train", "arch": arch,
                      "cfg": over, "model_axis": m,
                      "weights": f"{name}_w.npz",
                      "tokens": f"{name}_tok.npy"})
        ref[name] = (jcfg, w, tok)
    name = "remat_thread"
    arch, m, over = DENSE_CASES["qwen_drops"][:3]
    jcfg, cfg = _cfgs(arch, **over)
    np.savez(io / f"{name}_w.npz", **_flat(numpy_params(cfg, seed=130)))
    np.save(io / f"{name}_tok.npy", _tokens(cfg, (4, 16), seed=131))
    cases.append({"name": name, "kind": "remat_thread", "arch": arch,
                  "cfg": over, "model_axis": m, "weights": f"{name}_w.npz",
                  "tokens": f"{name}_tok.npy"})
    for i, arch in enumerate(PREFILL_ARCHS):
        jcfg, cfg = _cfgs(arch)
        w = any_family_params(cfg, seed=60 + i)
        tok = _tokens(cfg, (4, 24), seed=70 + i)
        name = f"prefill_{arch}"
        np.savez(io / f"{name}_w.npz", **_flat(w))
        np.save(io / f"{name}_tok.npy", tok)
        cases.append({"name": name, "kind": "prefill", "arch": arch,
                      "model_axis": 2, "weights": f"{name}_w.npz",
                      "tokens": f"{name}_tok.npy"})
        ref[name] = (jcfg, w, tok)
    data = _xent_inputs(seed=80)
    np.savez(io / "xent_in.npz", **data)
    for m in XENT_MESHES:
        name = f"xent_{m}"
        cases.append({"name": name, "kind": "xent", "arch": "tinyllama-1.1b",
                      "model_axis": m, "tokens": "xent_in.npz"})
        ref[name] = data
    cfg = reduced(get_config("recurrentgemma-9b"))
    w = any_family_params(cfg, seed=40)
    np.savez(io / "log_a_w.npz", **_flat(w))
    data = _log_a_inputs(cfg, seed=41)
    np.savez(io / "log_a_x.npz", **data)
    cases.append({"name": "log_a", "kind": "log_a",
                  "arch": "recurrentgemma-9b", "model_axis": 2,
                  "weights": "log_a_w.npz", "tokens": "log_a_x.npz"})
    ref["log_a"] = (cfg, w, data)
    cfg = reduced(get_config("whisper-medium"))
    w = any_family_params(cfg, seed=50)
    np.savez(io / "encdec_w.npz", **_flat(w))
    data = _decode_inputs(cfg, seed=51)
    np.savez(io / "encdec_in.npz", **data)
    for m in DECODE_MESHES:
        name = f"encdec_decode_{m}"
        cases.append({"name": name, "kind": "encdec_decode",
                      "arch": "whisper-medium", "model_axis": m,
                      "positions": DECODE_POSITIONS,
                      "weights": "encdec_w.npz", "tokens": "encdec_in.npz"})
        ref[name] = (cfg, w, data)
    (io / "job.json").write_text(json.dumps({"cases": cases}))
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(io), str(r),
                               str(WORLD)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env)
             for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), \
        "\n".join(l[-3000:] for l in logs)
    outs = {c["name"]: dict(np.load(io / f"out_{c['name']}.npz"))
            for c in cases}
    return ref, outs


def test_workers_import_no_jax(mesh_run):
    _, outs = mesh_run
    assert not any(bool(o["jax_imported"]) for o in outs.values())


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("impl", ["dense", "a2a", "local"])
def test_moe_impl_on_2x2_mesh_matches_jax(mesh_run, arch, impl):
    ref, outs = mesh_run
    jcfg, w, tok = ref[f"moe_{arch}"]
    jp = jax.tree.map(jnp.asarray, w)
    logits, _ = jmodels.get_module(jcfg).forward(jcfg, jp, jnp.asarray(tok))
    got = outs[f"moe_{arch}"][impl]
    assert got.shape == logits.shape
    assert_close(got, logits, **LOGIT_TOL)
    assert np.isfinite(outs[f"moe_{arch}"][impl + "_aux"]).all()


def _jax_drops(monkeypatch):
    """Wraps the JAX package's ``_dispatch`` (for this test only) so that
    each call adds its dropped entries to the returned list."""
    from repro.models import moe as jmoe
    drops = []
    real = jmoe._dispatch

    def counted(xf, top_e, top_p, E, C):
        xbuf, meta = real(xf, top_e, top_p, E, C)
        jax.debug.callback(lambda n: drops.append(int(n)),
                           jnp.sum(~meta[1]))
        return xbuf, meta
    monkeypatch.setattr(jmoe, "_dispatch", counted)
    return drops


@pytest.mark.parametrize("name", sorted(DENSE_CASES))
def test_dense_moe_drops_the_entries_jax_drops(mesh_run, name, monkeypatch):
    """The dense body on DTensors at capacity factor 0.5 against JAX's
    unsharded forward on the same weights: logits within LOGIT_TOL and
    the summed aux within AUX_RTOL (JAX's global value, not a mean of
    per-shard ones), with JAX dropping entries; the buffer split by
    experts or by capacity rows, and the weights kept split or gathered,
    as ``DENSE_CASES`` says."""
    ref, outs = mesh_run
    jcfg, w, tok = ref[name]
    out = outs[name]
    drops = _jax_drops(monkeypatch)
    logits, aux = jmodels.get_module(jcfg).forward(
        jcfg, jax.tree.map(jnp.asarray, w), jnp.asarray(tok))
    jax.effects_barrier()
    assert len(drops) == jcfg.num_layers and sum(drops) > 0, drops
    assert (str(out["route"]), str(out["form"])) == DENSE_CASES[name][4:]
    assert out["dense"].shape == logits.shape
    assert_close(out["dense"], logits, **LOGIT_TOL)
    assert abs(float(out["dense_aux"]) - float(aux)) <= AUX_RTOL * abs(
        float(aux))


def test_dense_moe_refuses_a_rule_that_splits_seq(mesh_run):
    """With ``seq`` mapped to the model axis the token shards are not in
    global token order: the dense body raises before any collective."""
    _, outs = mesh_run
    msg = str(outs["qwen_drops"]["seq_guard"])
    assert "split 'seq'" in msg and "global token order" in msg


@pytest.mark.parametrize("arch,model_axis", TRAIN_CASES)
def test_sharded_train_step_matches_jax_grads(mesh_run, arch, model_axis,
                                              monkeypatch):
    _train_step_matches_jax(mesh_run, f"train_{arch}", monkeypatch)


@pytest.mark.parametrize("case", sorted(DENSE_TRAIN_CASES))
def test_dense_moe_train_step_matches_jax_grads(mesh_run, case,
                                                monkeypatch):
    """The train step through the dense body's other forms: the weights
    gathered, both data ranks routing one batch row (each takes half of
    its gradients), and the capacity-row route on a data axis of 2."""
    _, outs = mesh_run
    out = outs[f"train_dense_{case}"]
    assert (str(out["route"]), str(out["form"])) == \
        (DENSE_CASES[case][4], "gather" if "gather" in case else "contract")
    _train_step_matches_jax(mesh_run, f"train_dense_{case}", monkeypatch)


def test_moe_backward_on_another_thread_recomputes_under_the_rules(
        mesh_run):
    """Autograd runs a CUDA graph's backward on a thread of its own,
    which sees none of the forward thread's rules: the checkpointed MoE
    layers' recompute still takes the dense body (it raises without
    rules), and every gradient equals the one of a backward on the
    forward's thread."""
    _, outs = mesh_run
    out = outs["remat_thread"]
    assert str(out["errors"]) == ""
    same = sorted(k for k in out if k.startswith("same/"))
    assert same and {"thread/" + k[5:] for k in same} == \
        {k for k in out if k.startswith("thread/")}
    for k in same:
        np.testing.assert_array_equal(out["thread/" + k[5:]], out[k])


def _train_step_matches_jax(mesh_run, name, monkeypatch):
    """Loss within LOSS_RTOL and every gradient within GRAD_REL of
    ``jax.value_and_grad`` on the same weights and tokens; a MoE step
    drops entries."""
    ref, outs = mesh_run
    jcfg, w, tok = ref[name]
    jp = jax.tree.map(jnp.asarray, w)
    batch = {"tokens": jnp.asarray(tok), "labels": jnp.asarray(tok)}
    mod = jmodels.get_module(jcfg)
    drops = _jax_drops(monkeypatch)
    (loss, _), grads = jax.value_and_grad(
        lambda p: mod.loss_fn(jcfg, p, batch), has_aux=True)(jp)
    jax.effects_barrier()
    assert (sum(drops) > 0) == jcfg.is_moe, drops
    out = outs[name]
    assert abs(float(out["loss"]) - float(loss)) <= LOSS_RTOL * abs(
        float(loss))
    jflat = _flat(jax.tree.map(np.asarray, grads))
    assert {k[len("grad/"):] for k in out if k.startswith("grad/")} == \
        set(jflat)
    for k, g in jflat.items():
        got = out["grad/" + k]
        rel = np.linalg.norm(got - g) / max(np.linalg.norm(g), 1e-30)
        assert rel <= GRAD_REL, (k, rel)


def test_rglru_log_a_body_matches_unsharded_with_grads(mesh_run):
    from repro_torch.models import rglru
    ref, outs = mesh_run
    cfg, w, data = ref["log_a"]
    out = outs["log_a"]
    params = params_from_numpy(w, "cpu", cfg=cfg)
    lp = {k: params["rec"][k].requires_grad_()
          for k in ("gate_a_w", "gate_a_b", "gate_x_w", "gate_x_b", "lam")}
    x = torch.from_numpy(data["x"]).requires_grad_()
    log_a, gate_i = rglru._log_a(rglru._slice(lp, 0), x)
    loss = (log_a * torch.from_numpy(data["c_a"])).sum() + \
        (gate_i * torch.from_numpy(data["c_i"])).sum()
    names = sorted(lp)
    grads = torch.autograd.grad(loss, [x] + [lp[k] for k in names])
    assert_close(out["log_a"], log_a.detach().numpy(), **BODY_TOL)
    assert_close(out["gate_i"], gate_i.detach().numpy(), **BODY_TOL)
    assert_close(out["grad/x"], grads[0].numpy(), **SUM_TOL)
    for k, g in zip(names, grads[1:]):
        assert_close(out[f"grad/{k}"], g.numpy(), **SUM_TOL,
                     err_msg=k)
    assert np.abs(out["grad/lam"]).max() > 0


@pytest.mark.parametrize("model_axis", DECODE_MESHES)
def test_encdec_decode_on_slot_split_cache_matches_unsharded(mesh_run,
                                                             model_axis):
    from repro_torch.models import encdec
    ref, outs = mesh_run
    cfg, w, data = ref[f"encdec_decode_{model_axis}"]
    out = outs[f"encdec_decode_{model_axis}"]
    assert f"Shard(dim=2)" in str(out["self_placements"])
    params = params_from_numpy(w, "cpu", cfg=cfg)
    cache = {k: torch.from_numpy(data[k].copy())
             for k in ("k", "v", "xk", "xv")}
    with torch.no_grad():
        for i, pos in enumerate(DECODE_POSITIONS):
            logits, cache = encdec.decode_step(
                cfg, params, torch.from_numpy(data["token"][i]), cache,
                torch.tensor(pos))
            assert_close(out[f"logits/{i}"], logits.numpy(), **BODY_TOL)
    # the written slots carry the layers' rounding; a write to a wrong
    # slot would be O(1) off
    for k, v in cache.items():
        assert_close(out[f"cache/{k}"], v.numpy(), **SUM_TOL, err_msg=k)


@pytest.mark.parametrize("arch", PREFILL_ARCHS)
def test_sharded_prefill_matches_unsharded_and_jax(mesh_run, arch):
    """build_step's prefill on (2,2): the logits within LOGIT_TOL of
    JAX's and SUM_TOL of the unsharded port's, every cache leaf of both
    (bf16 leaves within one bf16 step), each placed by its cache_spec
    axes in its dtype (no leaf built at the global batch or in fp32)."""
    from repro_torch import models as tmodels
    from repro_torch.configs.base import ShapeSpec
    ref, outs = mesh_run
    jcfg, w, tok = ref[f"prefill_{arch}"]
    out = outs[f"prefill_{arch}"]
    cfg = reduced(get_config(arch))
    b, s = tok.shape
    shape = ShapeSpec("p", s, b, "prefill")
    window, cl = tmodels.effective_window(cfg, shape), \
        tmodels.cache_len(cfg, shape)
    with torch.no_grad():
        tl, tc = tmodels.get_module(cfg).prefill(
            cfg, params_from_numpy(w, "cpu", cfg=cfg),
            torch.from_numpy(tok).long(), window=window, cache_len=cl)
    jl, jc = jmodels.get_module(jcfg).prefill(
        jcfg, jax.tree.map(jnp.asarray, w), jnp.asarray(tok), cl,
        window=window)
    assert_close(out["logits"], np.asarray(jl), **LOGIT_TOL)
    assert_close(out["logits"], tl.numpy(), **SUM_TOL)
    assert set(tc) == set(jc) == {k[len("cache/"):] for k in out
                                  if k.startswith("cache/")}
    for k, v in tc.items():
        tol = BF16_CACHE_TOL if v.dtype == torch.bfloat16 else SUM_TOL
        got = out[f"cache/{k}"]
        assert_close(got, v.float().numpy(), **tol, err_msg=k)
        assert_close(got, np.asarray(jc[k].astype(jnp.float32)), **tol,
                     err_msg=k)
        assert bool(out[f"placed/{k}"]), k


@pytest.mark.parametrize("model_axis", XENT_MESHES)
def test_vocab_split_loss_and_grad_match_unsharded_and_jax(mesh_run,
                                                           model_axis):
    """softmax_xent on logits split (batch over data, vocab over model):
    the loss and its gradient, unmasked and masked, against the plain
    loss and jax.grad of JAX's."""
    from repro.models import common as jcm
    from repro_torch.models import common as tcm
    ref, outs = mesh_run
    data, out = ref[f"xent_{model_axis}"], outs[f"xent_{model_axis}"]
    assert "Shard(dim=2)" in str(out["logits_placements"])
    for name, mask in (("plain", None), ("masked", data["mask"])):
        x = torch.from_numpy(data["logits"]).requires_grad_()
        tm = None if mask is None else torch.from_numpy(mask)
        loss = tcm.softmax_xent(x, torch.from_numpy(data["labels"]), tm)
        grad, = torch.autograd.grad(loss, x)
        jm = None if mask is None else jnp.asarray(mask)
        jloss, jgrad = jax.value_and_grad(
            lambda z: jcm.softmax_xent(z, jnp.asarray(data["labels"]), jm))(
                jnp.asarray(data["logits"]))
        for want_loss, want_grad in ((loss.detach().numpy(), grad.numpy()),
                                     (np.asarray(jloss), np.asarray(jgrad))):
            assert_close(out[f"{name}/loss"], want_loss, **XENT_TOL)
            assert_close(out[f"{name}/grad"], want_grad, **XENT_TOL)
        assert np.abs(out[f"{name}/grad"]).max() > 0
