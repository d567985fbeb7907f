"""The port's configs against the JAX package's, and the three dense-family
configs that serve through the transformer: Llama3-8B, Qwen3-8B and
Chameleon-34B (family ``vlm``, the same decoder).

The port lists every JAX config (since the audio family came, no family
is left unported); each config equals its JAX twin field by field, before and after ``reduced``; each reduced model gives the JAX
package's logits from the same numpy weights (rtol 1e-4 / atol 1e-5: both
sides compute in fp32 and differ in summation order only); and the serve
and train command lines bootstrap and run each reduced model on the CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jmodels
from repro.configs.base import get_config as jget_config
from repro.configs.base import list_configs as jlist_configs
from repro.configs.base import reduced as jreduced
from repro.models import transformer as jtf
from repro_torch import models
from repro_torch.configs.base import get_config, list_configs, reduced
from repro_torch.convert import params_from_numpy
from repro_torch.core.modelstore import ModelStore
from repro_torch.models import common as cm
from repro_torch.models import transformer as ttf

from conftest import assert_close

NEW = ["llama3-8b", "qwen3-8b", "chameleon-34b"]
TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_config_list_is_the_jax_list_minus_unported_families():
    unported = set(jlist_configs()) - set(list_configs())
    assert unported == set()
    assert list_configs() == sorted(jlist_configs())
    for name in list_configs():
        assert models.get_module(get_config(name)).__name__ == \
            jmodels.get_module(jget_config(name)).__name__.replace(
                "repro.", "repro_torch.", 1)


@pytest.mark.parametrize("name", NEW)
def test_config_equals_jax_field_by_field(name):
    cfg, jcfg = get_config(name), jget_config(name)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(reduced(cfg)) == \
        dataclasses.asdict(jreduced(jcfg))
    for prop in ("resolved_head_dim", "q_dim", "kv_dim", "is_moe"):
        assert getattr(cfg, prop) == getattr(jcfg, prop)
    assert cfg.param_count() == jcfg.param_count()
    assert models.get_module(cfg) is ttf


def test_llama3_keeps_its_window_and_rope_theta():
    cfg = get_config("llama3-8b")
    assert (cfg.sliding_window, cfg.rope_theta) == (8192, 500_000.0)
    assert get_config("qwen3-8b").qk_norm and get_config("chameleon-34b").qk_norm


def _numpy_params(cfg, seed=0):
    """Weights at the JAX package's scales; norm weights (zeros at init)
    get small random values, so the (1 + weight) scales are exercised."""
    rng = np.random.default_rng(seed)

    def leaf(p):
        std = 0.1 if p.init == "zeros" else p.std
        return (std * rng.standard_normal(p.shape)).astype(np.float32)
    return cm.map_template(leaf, models.param_template(cfg))


@pytest.mark.parametrize("name", NEW)
def test_reduced_model_logits_match_jax(name):
    cfg, jcfg = reduced(get_config(name)), jreduced(jget_config(name))
    np_params = _numpy_params(cfg)
    jp = jax.tree.map(jnp.asarray, np_params)
    tp = params_from_numpy(np_params, "cpu", cfg=cfg)
    toks = np.random.default_rng(1).integers(1, cfg.vocab_size, (2, 12)) \
        .astype(np.int32)
    assert_close(ttf.forward(cfg, tp, torch.from_numpy(toks).long()),
                 jtf.forward(jcfg, jp, jnp.asarray(toks)), **TOL)
    jl, _ = jtf.prefill(jcfg, jp, jnp.asarray(toks), 16,
                        cache_dtype=jnp.float32)
    tl, _ = ttf.prefill(cfg, tp, torch.from_numpy(toks).long(), 16,
                        cache_dtype=torch.float32)
    assert_close(tl, jl, **TOL)


@pytest.mark.parametrize("name", NEW)
def test_serve_and_train_clis_bootstrap_the_reduced_model(name, tmp_path,
                                                          capsys):
    from repro_torch.launch import serve, train
    serve.main(["--store", str(tmp_path / "serve"), "--model", name,
                "--device", "cpu", "--requests", "2", "--max-new", "4",
                "--prompt-len", "8", "--cache-len", "32"])
    out = capsys.readouterr().out
    assert f"bootstrapped {name}:v1" in out
    assert list(ModelStore(tmp_path / "serve").list_models()) == [name]
    losses = train.main(["--arch", name, "--device", "cpu", "--steps", "1",
                         "--batch", "2", "--seq", "16", "--publish",
                         str(tmp_path / "train")])
    assert len(losses) == 1 and np.isfinite(losses).all()
    assert list(ModelStore(tmp_path / "train").list_models()) == [name]
