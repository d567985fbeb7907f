"""The port's sharded paths on a CPU mesh against the JAX package's
single-device results.

Four gloo ranks (``tests/torch_mesh_worker.py``, in subprocesses that
import no JAX) run the port on two meshes of one world: (data=2,
model=2) and (data=1, model=4).  On (2,2): reduced Qwen3-MoE and
Granite-MoE (capacity factor 8, so no path drops a token) through
``moe_impl`` 'dense', 'a2a' and 'local', logits within 1e-4 of JAX's
forward; and the sharded train step (``launch.dryrun.build_step``) of
reduced TinyLlama (8 q heads split over the model axis, its one kv head
replicated), loss within 1e-4 relative and every gradient within 1e-3
relative norm of ``jax.value_and_grad``.  On (1,4): the same train step
for reduced Llama3-8B, 8 q heads split four ways and 2 kv heads
replicated, so each rank's two q heads meet the kv head of their group.
Weights are made once in numpy.
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
from repro_torch.configs.base import get_config, reduced

from conftest import assert_close
from test_torch_transformer import numpy_params

WORLD = 4
MOE_ARCHS = ["qwen3-moe-235b-a22b", "granite-moe-3b-a800m"]
TRAIN_CASES = [("tinyllama-1.1b", 2), ("llama3-8b", 4)]
LOGIT_TOL = dict(rtol=1e-4, atol=1e-5)
LOSS_RTOL = 1e-4
GRAD_REL = 1e-3
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
    for i, (arch, m) in enumerate(TRAIN_CASES):
        jcfg, cfg = _cfgs(arch)
        w = numpy_params(cfg, seed=20 + i)
        tok = _tokens(cfg, (4, 32), seed=30 + i)
        name = f"train_{arch}"
        np.savez(io / f"{name}_w.npz", **_flat(w))
        np.save(io / f"{name}_tok.npy", tok)
        cases.append({"name": name, "kind": "train", "arch": arch,
                      "model_axis": m, "weights": f"{name}_w.npz",
                      "tokens": f"{name}_tok.npy"})
        ref[name] = (jcfg, w, tok)
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


@pytest.mark.parametrize("arch,model_axis", TRAIN_CASES)
def test_sharded_train_step_matches_jax_grads(mesh_run, arch, model_axis):
    ref, outs = mesh_run
    jcfg, w, tok = ref[f"train_{arch}"]
    jp = jax.tree.map(jnp.asarray, w)
    batch = {"tokens": jnp.asarray(tok), "labels": jnp.asarray(tok)}
    mod = jmodels.get_module(jcfg)
    (loss, _), grads = jax.value_and_grad(
        lambda p: mod.loss_fn(jcfg, p, batch), has_aux=True)(jp)
    out = outs[f"train_{arch}"]
    assert abs(float(out["loss"]) - float(loss)) <= LOSS_RTOL * abs(
        float(loss))
    jflat = _flat(jax.tree.map(np.asarray, grads))
    assert {k[len("grad/"):] for k in out if k.startswith("grad/")} == \
        set(jflat)
    for k, g in jflat.items():
        got = out["grad/" + k]
        rel = np.linalg.norm(got - g) / max(np.linalg.norm(g), 1e-30)
        assert rel <= GRAD_REL, (k, rel)
