"""Store and engine parity: artifacts cross between the two packages, int8
weights are equal bit for bit, and the port's InferenceEngine on the CPU
answers as the JAX InferenceEngine does."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import importer as jimporter
from repro.core.engine import InferenceEngine as JInferenceEngine
from repro.core.modelstore import ModelStore as JModelStore
from repro.core.quantize import quantize_tree as jquantize_tree
from repro_torch.convert import params_from_numpy
from repro_torch.core import importer
from repro_torch.core.engine import InferenceEngine
from repro_torch.core.modelstore import ModelStore, flatten_params
from repro_torch.core.quantize import (QTensor, compression_ratio, quantize,
                                       quantize_tree, tree_bytes)

from conftest import assert_close
from test_torch_graph import graphs, inputs, numpy_params


@pytest.fixture(scope="module")
def nin():
    jg, tg = graphs("nin-cifar10")
    np_params = numpy_params(tg, seed=7)
    jparams = {l: {k: jnp.asarray(v) for k, v in g.items()}
               for l, g in np_params.items()}
    tparams = params_from_numpy(np_params, "cpu", graph=tg)
    return jg, tg, jparams, tparams, inputs(tg, 4, seed=8)


def _publish(side, root, nin, int8):
    jg, tg, jparams, tparams, _ = nin
    if side == "jax":
        doc, _ = jimporter.to_caffe_json(jg, jparams)
        return JModelStore(root).publish("nin", doc, jparams, int8=int8)
    doc, _ = importer.to_caffe_json(tg, tparams)
    return ModelStore(root).publish("nin", doc, tparams, int8=int8)


# ---------------------------------------------------------------------------
# Store: one layout, both directions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_artifact_loads_in_the_other_package(tmp_path, nin, writer, int8):
    rec = _publish(writer, tmp_path, nin, int8)
    reader = ModelStore if writer == "jax" else JModelStore
    got = reader(tmp_path).get("nin")            # checks the sha256
    assert got.manifest["weights_sha256"] == rec.manifest["weights_sha256"]
    assert got.manifest["int8"] is int8
    raw = got.load_params(dequantize=False)
    w = raw["conv0"]["w"]
    if int8:
        assert type(w).__name__ == "QTensor" and w.axis == 3
    want = _publish("torch" if writer == "jax" else "jax",
                    tmp_path / "other", nin, int8)
    other = (JModelStore if writer == "jax" else ModelStore)(
        tmp_path / "other").get("nin").load_params()
    mine = got.load_params()
    for layer in other:
        for k in other[layer]:
            np.testing.assert_array_equal(np.asarray(mine[layer][k]),
                                          np.asarray(other[layer][k]))
    assert want.manifest["num_tensors"] == rec.manifest["num_tensors"]


def test_store_detects_corruption(tmp_path, nin):
    rec = _publish("torch", tmp_path, nin, False)
    data = bytearray((rec.path / "weights.npz").read_bytes())
    data[len(data) // 2] ^= 0xFF
    (rec.path / "weights.npz").write_bytes(bytes(data))
    with pytest.raises(IOError, match="checksum"):
        ModelStore(tmp_path).get("nin")


def test_store_versioning(tmp_path, nin):
    _publish("torch", tmp_path, nin, False)
    _publish("torch", tmp_path, nin, True)
    store = ModelStore(tmp_path)
    assert store.list_models() == {"nin": ["v1", "v2"]}
    assert store.get("nin").version == "v2"
    assert store.get("nin", "v1").manifest["int8"] is False


# ---------------------------------------------------------------------------
# int8: equal to the JAX package's, bit for bit
# ---------------------------------------------------------------------------


def test_int8_q_and_scale_equal_jax(nin):
    _, _, jparams, tparams, _ = nin
    jq, tq = jquantize_tree(jparams), quantize_tree(tparams)
    n = 0
    for layer in jq:
        for k, jv in jq[layer].items():
            tv = tq[layer][k]
            if isinstance(tv, QTensor):
                n += 1
                assert tv.axis == jv.axis
                np.testing.assert_array_equal(tv.q.numpy(), np.asarray(jv.q))
                np.testing.assert_array_equal(tv.scale.numpy(),
                                              np.asarray(jv.scale))
            else:
                np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert n == 9
    flat = flatten_params(tq)
    assert {"conv0/w/#q", "conv0/w/#scale", "conv0/w/#axis", "conv0/b"} <= set(flat)


def test_quantize_zero_channel_and_bytes():
    x = torch.zeros(8, 4)
    x[:, 1] = torch.linspace(-1, 1, 8)
    qt = quantize(x)
    assert torch.isfinite(qt.dequantize()).all()
    assert_close(qt.dequantize(), x, rtol=0, atol=1 / 127)
    tree = {"a": {"w": torch.randn(64, 64), "b": torch.zeros(64)}}
    q = quantize_tree(tree)
    assert tree_bytes(q) == 64 * 64 + 64 * 4 + 64 * 4
    assert compression_ratio(q) == (64 * 64 * 4 + 64 * 4) / tree_bytes(q)


# ---------------------------------------------------------------------------
# Engine: the command queue on the CPU against the JAX engine
# ---------------------------------------------------------------------------


def test_engine_predict_and_queue_match_jax(tmp_path, nin):
    _publish("torch", tmp_path, nin, False)
    x = nin[4]
    want = JInferenceEngine(JModelStore(tmp_path)).predict("nin", x)
    eng = InferenceEngine(ModelStore(tmp_path), device="cpu")
    assert eng.backend == "ref"
    y = eng.predict("nin", x)
    assert tuple(y.shape) == (4, 10) and y.device.type == "cpu"
    assert_close(y, want, rtol=1e-4, atol=1e-6)
    cb = eng.enqueue("nin", torch.from_numpy(x))
    assert eng.queue == [cb]
    assert_close(cb.wait_until_completed(), y, rtol=1e-6, atol=0)
    assert cb.completed_at >= cb.committed_at
    assert eng.fence() == [cb.result] and eng.queue == []
    assert eng.stats["dispatches"] == 2 and eng.stats["switches"] == 1
    assert eng.stats["weight_bytes_avoided"] == 966_986 * 4


def test_engine_cuda_backend_on_cpu_matches_ref(tmp_path, nin):
    """The kernel wrappers' CPU path (plain versions) through the engine."""
    _publish("torch", tmp_path, nin, False)
    x = nin[4]
    store = ModelStore(tmp_path)
    y = InferenceEngine(store, device="cpu").predict("nin", x)
    y_k = InferenceEngine(store, device="cpu", backend="cuda").predict("nin", x)
    assert_close(y_k, y, rtol=1e-4, atol=1e-6)


def test_engine_int8_model_close_to_fp32(tmp_path, nin):
    _publish("torch", tmp_path / "q", nin, True)
    _publish("torch", tmp_path / "f", nin, False)
    x = nin[4]
    y_q = InferenceEngine(ModelStore(tmp_path / "q"), device="cpu").predict("nin", x)
    y = InferenceEngine(ModelStore(tmp_path / "f"), device="cpu").predict("nin", x)
    assert float((y_q - y).abs().max()) < 0.05
    assert int(y_q[0].argmax()) == int(y[0].argmax())
    # and the same int8 artifact gives the JAX engine's answer
    want = JInferenceEngine(JModelStore(tmp_path / "q")).predict("nin", x)
    assert_close(y_q, want, rtol=1e-4, atol=1e-6)


def test_resident_cache_lru_and_switches(tmp_path, nin):
    jg, tg, jparams, tparams, x = nin
    store = ModelStore(tmp_path)
    doc, _ = importer.to_caffe_json(tg, tparams)
    for name in ("a", "b", "c"):
        store.publish(name, doc, tparams)
    eng = InferenceEngine(store, device="cpu", max_resident=2)
    for name in ("a", "b", "a", "c"):
        eng.predict(name, x[:1])
    assert eng.cache.resident == [("a", "v1"), ("c", "v1")]
    assert (eng.cache.hits, eng.cache.misses) == (1, 3)
    assert eng.stats["switches"] == 4
    assert len(eng.switch_log) == 4


def test_engine_without_device_needs_cuda(tmp_path, monkeypatch):
    """The default device is CUDA; with none, the engine raises instead of
    picking the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(ModelStore(tmp_path))
