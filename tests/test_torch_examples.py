"""The four torch examples (``examples/*_torch.py``) against their JAX
twins on the CPU, on the same weights crossed through the model store's
on-disk format (``weights.npz`` + ``model.json``), never by re-seeding.

* quickstart: the JAX script runs as it is (its store kept); the port
  reads the JAX artifact, classifies the JAX script's images, and gives
  the same class ids; both print the same lines, numbers aside.
* compress_models: the JAX script runs as it is; the port starts from
  the JAX weights published to a store: the int8 ratio and the top-1
  agreement equal, the stage report within 1e-4 (two SVDs, two prunes
  of fp32 numbers), the same lines printed, numbers aside.
* serve_batched: the JAX script's body at 2 rounds publishes the three
  reduced models; the port serves 2 rounds from that store: the same
  model picked each round and the same greedy tokens.
* train_publish_serve: JAX's initial weights go through a store into
  the port's trainer: per-step losses within rtol 1e-4 for 2 steps
  (batch 8 x 128, the script's); the artifact JAX publishes, served by
  the port, gives JAX's greedy tokens.

The JAX scripts are loaded from their files and left as they are; where
a test needs a size the script does not take, it runs the script's
body with that size.
"""
import importlib.util
import pathlib
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import models as jmodels
from repro.checkpoint.ckpt import load_published as jload_published
from repro.checkpoint.ckpt import publish_checkpoint as jpublish
from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.core.importer import to_caffe_json as jto_caffe_json
from repro.core.modelstore import ModelStore as JStore
from repro.core.selector import ContextSpec as JContextSpec
from repro.core.selector import MetaSelector as JMetaSelector
from repro.core.selector import featurize as jfeaturize
from repro.models import cnn as jcnn
from repro.serving.engine import MultiModelServer as JServer
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch.core.modelstore import ModelStore as TStore

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"
STAGE_TOL = 1e-4
LOSS_RTOL = 1e-4


def _load(name):
    """``examples/<name>.py`` as a module (its ``main`` not run)."""
    spec = importlib.util.spec_from_file_location(f"example_{name}",
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Kept:
    """A ``tempfile.TemporaryDirectory`` stand-in that keeps ``path``."""

    def __init__(self, path):
        self.path = pathlib.Path(path)
        self.path.mkdir(parents=True, exist_ok=True)

    def __enter__(self):
        return str(self.path)

    def __exit__(self, *exc):
        return False


def _keep_store(mod, path, monkeypatch):
    monkeypatch.setattr(mod, "tempfile", types.SimpleNamespace(
        TemporaryDirectory=lambda: _Kept(path)))


def _shape(lines):
    """Printed lines with every number replaced by '#'."""
    return [re.sub(r"\d+(\.\d+)?", "#", l) for l in lines if l.strip()]


def _numpy_tree(params):
    return {k: _numpy_tree(v) if isinstance(v, dict) else v.numpy()
            for k, v in params.items()}


def test_quickstart_class_ids_equal_jax(tmp_path, monkeypatch, capsys):
    jq, tq = _load("quickstart"), _load("quickstart_torch")
    _keep_store(jq, tmp_path / "jax", monkeypatch)
    jq.main()
    jlines = capsys.readouterr().out.splitlines()
    jpreds = eval(next(l for l in jlines if l.startswith("predictions:"))
                  .split(":", 1)[1])
    rec = TStore(tmp_path / "jax").get("nin-cifar10")
    assert rec.manifest["int8"]
    params = _numpy_tree(rec.load_params())
    images = np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                          (8, 3, 32, 32)))
    preds = tq.run("cpu", params=params, images=images)
    tlines = capsys.readouterr().out.splitlines()
    assert preds == jpreds and len(preds) == 8
    assert _shape(tlines) == _shape(jlines)


def test_compress_report_equals_jax(tmp_path, capsys):
    from repro.core import compress as jcompress
    from repro.core import quantize as jquantize
    jc, tc = _load("compress_models"), _load("compress_models_torch")
    jc.main()
    jlines = capsys.readouterr().out.splitlines()
    # the JAX script's weights and images, its numbers unrounded
    g = jcnn.graph_for(jget_config("nin-cifar10"))
    params = g.init_params(jax.random.PRNGKey(0))
    x = jax.random.normal(jax.random.PRNGKey(1), (32, 3, 32, 32))
    y_fp = g.apply(params, x)
    qt = jquantize.quantize_tree(params)
    ratio = jquantize.tree_bytes(params) / jquantize.tree_bytes(qt)
    y_q = g.apply(jquantize.dequantize_tree(qt), x)
    agree = float((jnp.argmax(y_q, -1) == jnp.argmax(y_fp, -1)).mean())
    w = params["conv7"]["w"]
    w2d = w.reshape(w.shape[0], -1)
    rep = jcompress.compress_report(w2d, rank=min(64, min(w2d.shape) // 2),
                                    sparsity=0.9)
    # the weights cross through a store
    doc, _ = jto_caffe_json(g, params)
    JStore(tmp_path).publish("nin-cifar10", doc, params)
    got = tc.run("cpu", params=_numpy_tree(
        TStore(tmp_path).get("nin-cifar10").load_params()),
        x=np.asarray(x))
    tlines = capsys.readouterr().out.splitlines()
    assert got["layer"] == "conv7"
    assert got["ratio"] == ratio and got["agree"] == agree
    for k in ("int8", "pruned", "lowrank", "lowrank+int8"):
        for field in ("ratio", "error"):
            assert abs(got["report"][k][field] - float(rep[k][field])) \
                <= STAGE_TOL, (k, field)
    assert _shape(tlines) == _shape(jlines)


def _jax_serve_batched(root, rounds, requests=3):
    """examples/serve_batched.py's body at ``rounds`` rounds, keeping the
    store at ``root``; one (location, model, tokens) a round."""
    models = ["tinyllama-1.1b", "qwen3-0.6b", "rwkv6-3b"]
    rng = np.random.default_rng(0)
    store = JStore(root)
    for i, arch in enumerate(models):
        cfg = jreduced(jget_config(arch))
        jpublish(store, arch, cfg,
                 jmodels.init_params(cfg, jax.random.PRNGKey(i)))
    spec = JContextSpec(num_locations=4, history_classes=4)
    feats, labels = [], []
    for n in range(300):
        loc = n % len(models)
        feats.append(jfeaturize(spec, hour=n % 24, weekday=n % 7,
                                location=loc, history=np.eye(4)[n % 4]))
        labels.append(loc)
    sel = JMetaSelector(spec, models)
    sel.fit(jnp.stack(feats), jnp.asarray(labels))
    server = JServer(store, max_resident=3, selector=sel, max_batch=4,
                     cache_len=96)
    uid, served = 0, []
    for round_i in range(rounds):
        loc = round_i % len(models)
        ctx = jfeaturize(spec, hour=9 + round_i, weekday=2, location=loc,
                         history=np.eye(4)[0])
        reqs = [JRequest(uid=uid + j, prompt=list(rng.integers(1, 250, 12)),
                         max_new_tokens=8) for j in range(requests)]
        uid += requests
        server.serve(reqs, context_feats=ctx)
        served.append((loc, server.switch_log[-1][0],
                       [[int(t) for t in r.output] for r in reqs]))
    return served


def test_serve_batched_picks_and_tokens_equal_jax(tmp_path):
    ts = _load("serve_batched_torch")
    want = _jax_serve_batched(tmp_path, rounds=2)
    got = ts.run("cpu", store_root=tmp_path, rounds=2)
    assert [m for _, m, _ in want] == ["tinyllama-1.1b", "qwen3-0.6b"]
    assert got == want


def _jax_serve(root, arch):
    """examples/train_publish_serve.py's serving half on the artifact at
    ``root``: the three requests' tokens."""
    cfg, params, _ = jload_published(JStore(root), arch)
    eng = JEngine(cfg, params, max_batch=4, cache_len=128)
    rng = np.random.default_rng(0)
    reqs = [JRequest(uid=i, prompt=list(rng.integers(1, cfg.vocab_size, 10)),
                     max_new_tokens=12) for i in range(3)]
    eng.generate_batch(reqs)
    return [[int(t) for t in r.output] for r in reqs]


def _jax_train_publish(root, init_root, arch, steps):
    """examples/train_publish_serve.py's training half (``repro.launch.
    train.train``'s loop: its schedule, data and publish; the host mesh's
    batch sharding left out, which this container's JAX refuses), from
    ``init_params(PRNGKey(0))``, which it first publishes at
    ``init_root``; returns the per-step losses."""
    from repro.data.pipeline import DataConfig, SyntheticLM
    from repro.launch.train import make_train_step
    from repro.optim.adamw import AdamW, cosine_schedule
    cfg = jreduced(jget_config(arch))
    params = jmodels.init_params(cfg, jax.random.PRNGKey(0))
    jpublish(JStore(init_root), arch, cfg, params)
    opt = AdamW(lr=cosine_schedule(3e-4, 20, steps))
    state = opt.init(params)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=128,
                                  global_batch=8, seed=0))
    step_fn = make_train_step(cfg, opt)
    losses = []
    for step in range(steps):
        batch = {k: jnp.asarray(v) for k, v in data.batch(step).items()}
        params, state, metrics = step_fn(params, state, batch)
        losses.append(float(metrics["loss"]))
    jpublish(JStore(root), cfg.name, cfg, params,
             metadata={"steps": steps, "final_loss": losses[-1]})
    return losses


def test_train_publish_serve_losses_and_tokens_equal_jax(tmp_path):
    tt = _load("train_publish_serve_torch")
    arch, steps = "qwen3-0.6b", 2
    jlosses = _jax_train_publish(tmp_path / "jax", tmp_path / "init", arch,
                                 steps)
    losses = tt.train_and_publish("cpu", tmp_path / "torch", arch=arch,
                                  steps=steps, init_root=tmp_path / "init")
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_RTOL)
    want = _jax_serve(tmp_path / "jax", arch)
    got = tt.reload_and_serve("cpu", tmp_path / "jax", arch=arch)
    assert [list(r.output) for r in got] == want
    assert all(len(t) == 12 for t in want)


@pytest.mark.parametrize("name", ["quickstart_torch", "serve_batched_torch",
                                  "train_publish_serve_torch",
                                  "compress_models_torch"])
def test_example_runs_on_the_card_by_default(name, monkeypatch):
    """Without CUDA the default device raises; nothing falls back to the
    CPU."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = _load(name)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])
