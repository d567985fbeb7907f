"""Meta-selector parity: the port's ``core.selector`` against the JAX
package's, and ``MultiModelServer`` routing by it.

Features are bit-equal (both build them in float64 numpy and cast once).
From the same numpy initial weights, 300 full-batch gradient steps give
w and b within 1e-5 (fp32 on both sides, summation order apart), and the
same picks and accuracy.  A CPU ``MultiModelServer(max_resident=3)``
with the selector serves the three reduced families of
``examples/serve_batched.py`` from a store the JAX package published:
each context picks its label's model, which gives the tokens its own
``ServingEngine`` gives.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jmodels
from repro.checkpoint.ckpt import publish_checkpoint as jpublish
from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.core import selector as jsel
from repro.core.modelstore import ModelStore as JStore
from repro_torch.checkpoint.ckpt import load_published
from repro_torch.core import selector as tsel
from repro_torch.core.modelstore import ModelStore as TStore
from repro_torch.serving.engine import MultiModelServer, Request, ServingEngine

from test_torch_transformer import one_torch_thread  # noqa: F401

MODELS = ["tinyllama-1.1b", "qwen3-0.6b", "rwkv6-3b"]
SPEC = dict(num_locations=4, history_classes=4)


def contexts(n=300):
    """The training contexts of examples/serve_batched.py: location i
    prefers model i."""
    out = []
    for i in range(n):
        out.append(dict(hour=i % 24, weekday=i % 7, location=i % len(MODELS),
                        history=np.eye(4)[i % 4]))
    return out, np.arange(n) % len(MODELS)


@pytest.mark.parametrize("ctx", [
    dict(hour=0, weekday=0, location=0, history=[1, 0, 0, 0]),
    dict(hour=13.5, weekday=9, location=6, history=[3, 1, 0, 2]),
    dict(hour=23.99, weekday=6, location=3, history=[0, 0, 0, 0]),
    dict(hour=7.25, weekday=2, location=1, history=[0.1, 0.2, 0.3, 0.4])])
def test_featurize_is_bit_equal(ctx):
    want = np.asarray(jsel.featurize(jsel.ContextSpec(**SPEC), **ctx))
    got = tsel.featurize(tsel.ContextSpec(**SPEC), **ctx)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
    assert tsel.ContextSpec(**SPEC).dim == jsel.ContextSpec(**SPEC).dim == 17
    with pytest.raises(ValueError, match="history"):
        tsel.featurize(tsel.ContextSpec(**SPEC), **{**ctx, "history": [1]})


def fitted_pair():
    ctxs, labels = contexts()
    jspec, tspec = jsel.ContextSpec(**SPEC), tsel.ContextSpec(**SPEC)
    jf = jnp.stack([jsel.featurize(jspec, **c) for c in ctxs])
    tf = torch.stack([tsel.featurize(tspec, **c) for c in ctxs])
    rng = np.random.default_rng(0)
    w0 = (0.01 * rng.standard_normal((jspec.dim, len(MODELS)))).astype(
        np.float32)
    js = jsel.MetaSelector(jspec, MODELS)
    ts = tsel.MetaSelector(tspec, MODELS, generator=torch.Generator(),
                           device="cpu")
    js.w, js.b = jnp.asarray(w0), jnp.zeros(len(MODELS), jnp.float32)
    ts.w, ts.b = torch.from_numpy(w0.copy()), torch.zeros(len(MODELS))
    jl = js.fit(jf, jnp.asarray(labels))
    tl = ts.fit(tf, torch.from_numpy(labels))
    return (js, jf, jl), (ts, tf, tl), labels


def test_fit_select_and_accuracy_match_jax():
    (js, jf, jl), (ts, tf, tl), labels = fitted_pair()
    np.testing.assert_allclose(ts.w.numpy(), np.asarray(js.w), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(ts.b.numpy(), np.asarray(js.b), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert ts.accuracy(tf, torch.from_numpy(labels)) == \
        js.accuracy(jf, jnp.asarray(labels)) == 1.0
    for i in range(0, 300, 7):
        assert ts.rank(tf[i]) == js.rank(jf[i])
        assert ts.select(tf[i], k=2) == js.select(jf[i], k=2)


def test_initial_weights_come_from_the_generator():
    spec = tsel.ContextSpec(**SPEC)
    a = tsel.MetaSelector(spec, MODELS, device="cpu",
                          generator=torch.Generator().manual_seed(1))
    b = tsel.MetaSelector(spec, MODELS, device="cpu",
                          generator=torch.Generator().manual_seed(1))
    c = tsel.MetaSelector(spec, MODELS, device="cpu",
                          generator=torch.Generator().manual_seed(2))
    assert torch.equal(a.w, b.w) and not torch.equal(a.w, c.w)
    assert a.w.shape == (spec.dim, 3) and float(a.w.abs().max()) < 0.1
    assert torch.equal(a.b, torch.zeros(3))


def test_multimodel_server_routes_by_the_selector(tmp_path):
    """Six rounds, as examples/serve_batched.py runs them: each context
    picks the model of its location, which is loaded once
    (max_resident=3) and serves what its own engine serves."""
    store = JStore(tmp_path)
    for i, arch in enumerate(MODELS):
        cfg = jreduced(jget_config(arch))
        jpublish(store, arch, cfg,
                 jmodels.init_params(cfg, jax.random.PRNGKey(i)))
    _, (sel, _, _), _ = fitted_pair()
    server = MultiModelServer(TStore(tmp_path), max_resident=3,
                              selector=sel, max_batch=4, cache_len=96,
                              device="cpu")
    spec = tsel.ContextSpec(**SPEC)
    rng = np.random.default_rng(0)
    picks = []
    for round_i in range(6):
        loc = round_i % len(MODELS)
        ctx = tsel.featurize(spec, hour=9 + round_i, weekday=2, location=loc,
                             history=np.eye(4)[0])
        prompts = [list(rng.integers(1, 250, 12)) for _ in range(3)]
        reqs = [Request(uid=j, prompt=p, max_new_tokens=8)
                for j, p in enumerate(prompts)]
        stats = server.serve(reqs, context_feats=ctx)
        model = server.switch_log[-1][0]
        picks.append(model)
        assert stats.tokens_out == 24
        cfg, params, _ = load_published(TStore(tmp_path), model)
        alone = [Request(uid=j, prompt=p, max_new_tokens=8)
                 for j, p in enumerate(prompts)]
        ServingEngine(cfg, params, max_batch=4, cache_len=96,
                      device="cpu").generate_batch(alone)
        assert [r.output for r in reqs] == [r.output for r in alone]
    assert picks == [MODELS[i % 3] for i in range(6)]
    assert (server.cache.hits, server.cache.misses) == (3, 3)
