"""Serving parity: model-store artifacts across the two packages, the
aligned baseline against the scheduler and the JAX engine, the
multi-model server's hot swap, and the CLI driver, on the CPU.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.core.modelstore import ModelStore as JStore
from repro.serving.engine import ServingEngine as JEngine
from repro.serving.engine import Request as JRequest
from repro_torch.checkpoint import ckpt as tckpt
from repro_torch.configs.base import get_config, reduced
from repro_torch.convert import params_to_numpy
from repro_torch.core.modelstore import ModelStore as TStore
from repro_torch.serving.engine import MultiModelServer, Request, ServingEngine

from test_torch_transformer import both_params, one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def tiny():
    cfg = reduced(get_config("tinyllama-1.1b"))
    jp, tp = both_params(cfg)
    return jreduced(jget_config("tinyllama-1.1b")), cfg, jp, tp


@pytest.mark.parametrize("int8", [False, True])
def test_artifacts_load_across_packages(tmp_path, tiny, int8):
    """Either package's publish_checkpoint loads in the other, passes the
    sha256 check and yields the same config and weights."""
    jcfg, cfg, jp, tp = tiny
    jckpt.publish_checkpoint(JStore(tmp_path), "from-jax", jcfg, jp,
                             int8=int8)
    tckpt.publish_checkpoint(TStore(tmp_path), "from-torch", cfg, tp,
                             int8=int8)
    cfg1, tp1, rec = tckpt.load_published(TStore(tmp_path), "from-jax")
    jcfg1, jp1, _ = jckpt.load_published(JStore(tmp_path), "from-torch")
    assert cfg1 == cfg and dataclasses.asdict(jcfg1) == dataclasses.asdict(cfg)
    assert rec.manifest["int8"] == int8
    got_t, got_j = params_to_numpy(tp1), jax.tree.map(np.asarray, jp1)
    want = params_to_numpy(tp)
    for name in ("embed", "unembed"):
        # int8 artifacts dequantize to the same fp32 numbers in both
        np.testing.assert_array_equal(got_t[name], got_j[name])
        tol = 0.02 * np.abs(want[name]).max() if int8 else 0
        np.testing.assert_allclose(got_t[name], want[name], rtol=0, atol=tol)
    np.testing.assert_array_equal(got_t["layers"]["wq"],
                                  got_j["layers"]["wq"])
    # a corrupted artifact fails the check in the port too
    (rec.path / "weights.npz").write_bytes(b"corrupt")
    with pytest.raises(IOError, match="checksum"):
        TStore(tmp_path).get("from-jax")


def test_aligned_baseline_matches_jax_and_the_scheduler(tiny):
    """The aligned loop through a ring that wraps (prompt 10 + 12 new in
    16 slots) equals the JAX engine's; without the wrap it equals the
    continuous scheduler's greedy output."""
    jcfg, cfg, jp, tp = tiny
    prompt = [1, 2, 3, 4, 5, 6, 7, 8, 9, 10]
    jr = [JRequest(uid=0, prompt=prompt, max_new_tokens=12)]
    tr = [Request(uid=0, prompt=prompt, max_new_tokens=12)]
    JEngine(jcfg, jp, max_batch=1, cache_len=16).generate_aligned(jr)
    ServingEngine(cfg, tp, max_batch=1, cache_len=16,
                  device="cpu").generate_aligned(tr)
    assert tr[0].output == jr[0].output and len(tr[0].output) == 12
    mix = [dict(prompt=[3, 1, 4, 1, 5], max_new_tokens=6),
           dict(prompt=[9, 2, 6, 5, 3], max_new_tokens=6)]
    eng = ServingEngine(cfg, tp, max_batch=2, cache_len=64, device="cpu")
    aligned = [Request(uid=i, **m) for i, m in enumerate(mix)]
    cont = [Request(uid=i, **m) for i, m in enumerate(mix)]
    eng.generate_aligned(aligned)
    stats = eng.generate_batch(cont)
    assert [r.output for r in cont] == [r.output for r in aligned]
    assert stats.tokens_out == 12 and eng.scheduler().host_syncs == 2


def test_multimodel_server_hot_swap(tmp_path):
    """Two reduced models behind an LRU of one: every switch misses,
    outputs equal each model's own engine."""
    store = TStore(tmp_path)
    params = {}
    for arch in ("tinyllama-1.1b", "qwen3-0.6b"):
        cfg = reduced(get_config(arch))
        params[arch] = (cfg, both_params(cfg, seed=3)[1])
        tckpt.publish_checkpoint(store, arch, cfg, params[arch][1])
    server = MultiModelServer(store, max_resident=1, max_batch=2,
                              cache_len=32, device="cpu")
    outs = []
    for name in ["tinyllama-1.1b", "qwen3-0.6b"] * 2:
        reqs = [Request(uid=0, prompt=[5, 6, 7], max_new_tokens=4)]
        stats = server.serve(reqs, model=name)
        assert stats.tokens_out == 4
        outs.append(reqs[0].output)
    assert server.cache.misses == 4 and server.cache.hits == 0
    assert [n for n, _ in server.switch_log] == \
        ["tinyllama-1.1b", "qwen3-0.6b"] * 2
    assert server.stats["switches"] == 4
    assert outs[0] == outs[2] and outs[1] == outs[3]
    for name, out in zip(["tinyllama-1.1b", "qwen3-0.6b"], outs):
        cfg, p = params[name]
        r = [Request(uid=0, prompt=[5, 6, 7], max_new_tokens=4)]
        ServingEngine(cfg, p, max_batch=2, cache_len=32,
                      device="cpu").generate_batch(r)
        assert r[0].output == out


def test_entry_points_default_to_the_card(tiny):
    _, cfg, _, tp = tiny
    if torch.cuda.is_available():
        assert ServingEngine(cfg, tp).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ServingEngine(cfg, tp)


def test_serve_driver_bootstraps_and_swaps(tmp_path, monkeypatch, capsys):
    from repro_torch.launch import serve
    monkeypatch.setattr("sys.argv", [
        "serve", "--store", str(tmp_path), "--device", "cpu",
        "--requests", "2", "--max-new", "4", "--prompt-len", "8",
        "--cache-len", "32"])
    serve.main()
    out = capsys.readouterr().out
    assert out.count("bootstrapped") == 2
    assert "resident-cache: 2 hits / 2 misses" in out
    assert sorted(TStore(tmp_path).list_models()) == ["qwen3-0.6b",
                                                      "tinyllama-1.1b"]
