"""Transformer parity: the port's prefill and lane-major decode against
the JAX package's, on the same numpy weights and tokens.

The reduced TinyLlama (GQA 8:1) and Qwen3 (qk-norm, tied embeddings,
GQA 2:1) configs of the JAX package, 2 layers at d_model 256.  Weights
are made once in numpy (the JAX package's ``init_params`` salts its keys
with Python's ``hash``) with nonzero norm weights, so that the
``(1 + weight)`` scale of ``rms_norm`` is exercised.  Prefill logits and
caches, then 8 teacher-forced ``decode_step_batch`` steps for the four
cache forms (ring fp32, ring int8, paged fp32, paged int8), agree within
rtol 1e-4: both sides compute in fp32 and differ in summation order
only.  The int8 payloads and scales of the prefill conversion are
bit-equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.models import transformer as jtf
from repro_torch.configs.base import ArchConfig, get_config, reduced
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.models import common as cm
from repro_torch.models import transformer as ttf
from repro_torch.models import param_template

from conftest import assert_close

ARCHS = ["tinyllama-1.1b", "qwen3-0.6b"]
TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's tensors here are tiny: one intra-op thread is faster
    and leaves the other test workers' cores alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def numpy_params(cfg, seed=0):
    """Weights at the JAX package's scales, from one numpy seed; norm
    weights (zeros at init) get small random values."""
    rng = np.random.default_rng(seed)

    def leaf(p):
        std = 0.1 if p.init == "zeros" else p.std
        return (std * rng.standard_normal(p.shape)).astype(np.float32)
    return cm.map_template(leaf, param_template(cfg))


def both_params(cfg, seed=0):
    """(the JAX tree, the port's tree) holding the same numbers."""
    np_params = numpy_params(cfg, seed)
    return (jax.tree.map(jnp.asarray, np_params),
            params_from_numpy(np_params, "cpu", cfg=cfg))


def t(a):
    return torch.from_numpy(np.array(a))


PROMPTS = [[3, 1, 4, 1, 5], [9, 2, 6, 5, 3, 5, 8, 9, 7, 9], [2, 7]]
CACHE_LEN = 32


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    jcfg = jreduced(jget_config(request.param))
    cfg = reduced(get_config(request.param))
    jp, tp = both_params(cfg)
    return jcfg, cfg, jp, tp


@pytest.fixture(scope="module")
def rows(arch):
    """Each of PROMPTS prefilled (B=1) by the JAX package: the last
    logits and the float cache row."""
    jcfg, _, jp, _ = arch
    out = []
    for p in PROMPTS:
        lg, c = jtf.prefill(jcfg, jp, jnp.asarray([p], jnp.int32), CACHE_LEN,
                            cache_dtype=jnp.float32)
        out.append((np.asarray(lg[0, -1]), c))
    return out


def test_configs_and_reduction_equal_jax():
    for name in ARCHS:
        jcfg = jget_config(name)
        cfg = get_config(name)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert dataclasses.asdict(reduced(cfg)) == \
            dataclasses.asdict(jreduced(jcfg))
        for prop in ("resolved_head_dim", "q_dim", "kv_dim", "is_moe"):
            assert getattr(cfg, prop) == getattr(jcfg, prop)
        assert cfg.param_count() == jcfg.param_count()
    # a spec either package publishes builds the other's config
    assert ArchConfig(**dataclasses.asdict(jget_config("qwen3-0.6b"))) == \
        get_config("qwen3-0.6b")


def test_convert_refuses_what_the_model_does_not_have():
    cfg = reduced(get_config("tinyllama-1.1b"))
    good = numpy_params(cfg)
    back = params_to_numpy(params_from_numpy(good, "cpu", cfg=cfg))
    np.testing.assert_array_equal(back["layers"]["wq"], good["layers"]["wq"])
    bad_shape = {**good, "final_ln": good["final_ln"][:-1]}
    with pytest.raises(ValueError, match="final_ln"):
        params_from_numpy(bad_shape, "cpu", cfg=cfg)
    bad_dtype = {**good, "embed": good["embed"].astype(np.float64)}
    with pytest.raises(TypeError, match="embed"):
        params_from_numpy(bad_dtype, "cpu", cfg=cfg)
    tied = reduced(get_config("qwen3-0.6b"))
    with pytest.raises(ValueError, match="unembed"):
        params_from_numpy({**numpy_params(tied),
                           "unembed": good["unembed"]}, "cpu", cfg=tied)


def test_forward_and_prefill_match_jax(arch):
    jcfg, cfg, jp, tp = arch
    rng = np.random.default_rng(1)
    toks = rng.integers(1, cfg.vocab_size, (2, 12)).astype(np.int32)
    assert_close(ttf.forward(cfg, tp, t(toks).long()),
                 jtf.forward(jcfg, jp, jnp.asarray(toks)), **TOL)
    # a ring shorter than the prompt: prefill keeps and rolls the tail
    for cache_len in (16, 8):
        jl, jc = jtf.prefill(jcfg, jp, jnp.asarray(toks), cache_len,
                             cache_dtype=jnp.float32)
        tl, tc = ttf.prefill(cfg, tp, t(toks).long(), cache_len,
                             cache_dtype=torch.float32)
        assert_close(tl, jl, **TOL)
        for key in ("k", "v"):
            assert_close(tc[key], jc[key], **TOL)


@pytest.mark.parametrize("layout", ["ring", "paged"])
@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_decode_step_batch_matches_jax(arch, rows, layout, kv_dtype):
    """8 teacher-forced steps of the lane-major decode from the same
    spliced cache: logits every step and the final cache."""
    jcfg, cfg, jp, tp = arch
    prompts = PROMPTS
    b, cache_len, ps = len(prompts), CACHE_LEN, 8
    paged = layout == "paged"
    kw = dict(page_size=ps, num_pages=1 + 2 * b * (cache_len // ps) + 3) \
        if paged else {}
    jcache = jtf.init_cache(jcfg, b, cache_len, jnp.float32,
                            kv_dtype=kv_dtype, **kw)
    tcache = ttf.init_cache(cfg, b, cache_len, torch.float32,
                            kv_dtype=kv_dtype, **kw)
    # fragmented, out-of-order pages: lane i gets pages 2i+1 (reversed
    # order) in a pool twice the size it needs
    w = cache_len // ps
    for i, (_, row) in enumerate(rows):
        jrow = jtf.cache_to_kv_dtype(jcfg, row, kv_dtype)
        trow = ttf.cache_to_kv_dtype(cfg, {k: t(v) for k, v in row.items()},
                                     kv_dtype)
        for key in jrow:                    # the int8 conversion is exact
            np.testing.assert_array_equal(trow[key].numpy(),
                                          np.asarray(jrow[key]))
        if paged:
            pages = np.arange(1 + 2 * w * i, 1 + 2 * w * (i + 1), 2)[::-1]
            jcache = jtf.cache_splice_paged(jcfg, jcache, jrow, i,
                                            jnp.asarray(pages.copy(),
                                                        jnp.int32), ps)
            ttf.cache_splice_paged(cfg, tcache, trow, i,
                                   t(pages.astype(np.int32)), ps)
        else:
            jcache = {k: c.at[:, i].set(jrow[k][:, 0])
                      for k, c in jcache.items()}
            for k, c in tcache.items():
                c[:, i] = trow[k][:, 0]
    for k in jcache:
        assert_close(tcache[k], jcache[k], rtol=0, atol=0)
    pos = np.array([len(p) for p in prompts], np.int32)
    toks = np.array([[int(np.argmax(lg))] for lg, _ in rows], np.int32)
    jstep = jax.jit(lambda c, tk, ps_: jtf.decode_step_batch(
        jcfg, jp, tk, c, ps_, attn_backend="ref"))
    for _ in range(8):
        jl, jcache = jstep(jcache, jnp.asarray(toks), jnp.asarray(pos))
        tl, tcache = ttf.decode_step_batch(cfg, tp, t(toks), tcache, t(pos),
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


def test_decode_step_matches_jax_and_wraps_the_ring(arch):
    """The B=1-per-position decode (the vmapped reference's body and the
    aligned baseline's step) through a ring that wraps."""
    jcfg, cfg, jp, tp = arch
    toks = np.array([[5, 4, 3, 2, 1, 7]], np.int32)
    _, jc = jtf.prefill(jcfg, jp, jnp.asarray(toks), 8,
                        cache_dtype=jnp.float32)
    tc = {k: t(v) for k, v in jc.items()}
    tok = np.array([[11]], np.int32)
    jstep = jax.jit(lambda tk, c, pos: jtf.decode_step(jcfg, jp, tk, c, pos))
    for pos in range(6, 12):                # slots 6, 7, 0, 1, ...
        jl, jc = jstep(jnp.asarray(tok), jc, jnp.int32(pos))
        tl, tc = ttf.decode_step(cfg, tp, t(tok), tc, pos)
        assert_close(tl, jl, **TOL)
        tok = np.asarray(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]
    for k in jc:
        assert_close(tc[k], jc[k], **TOL)
