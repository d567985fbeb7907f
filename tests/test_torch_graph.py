"""Graph parity: the port's op registry, graph, importer and weight
conversion against the JAX package's, on full-width NIN-CIFAR10 and
LeNet-MNIST with weights made by numpy and carried into both."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.core import importer as jimporter
from repro.core.ops import ApplyContext as JApplyContext
from repro.core.ops import REGISTRY as JREGISTRY
from repro.models import cnn as jcnn
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core import importer
from repro_torch.core.ops import REGISTRY
from repro_torch.models import cnn

from conftest import assert_close

MODELS = ["nin-cifar10", "lenet-mnist"]


def numpy_params(graph, seed=0):
    """He-scaled weights and nonzero biases, shaped from the port's graph
    (the same layouts as the JAX package's)."""
    rng = np.random.default_rng(seed)
    out = {}
    for layer, group in graph.init_params(torch.Generator()).items():
        out[layer] = {}
        for name, v in group.items():
            shape = tuple(v.shape)
            fan_in = int(np.prod(shape[1:])) if len(shape) == 4 else shape[0]
            scale = np.sqrt(2.0 / fan_in) if len(shape) > 1 else 0.1
            out[layer][name] = (scale * rng.standard_normal(shape)) \
                .astype(np.float32)
    return out


def graphs(name):
    return jcnn.graph_for(jax_get_config(name)), cnn.graph_for(get_config(name))


def inputs(graph, batch, seed=1):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((batch, *graph.input_shape)).astype(np.float32)


def jax_layers(graph, params, x, backend="ref"):
    """Every layer's output of the JAX graph (the loop of Graph.apply)."""
    ctx, outs = JApplyContext(), []
    for l in graph.layers:
        x = l.spec.backend(backend)(x, params.get(l.name), l.attrs, ctx)
        outs.append(x)
    return outs


@pytest.fixture(scope="module", params=MODELS)
def model(request):
    jg, tg = graphs(request.param)
    np_params = numpy_params(tg)
    jparams = {l: {k: jnp.asarray(v) for k, v in g.items()}
               for l, g in np_params.items()}
    return request.param, jg, tg, np_params, jparams


# ---------------------------------------------------------------------------
# Registry and analysis
# ---------------------------------------------------------------------------


def test_registry_kinds_and_caffe_types_equal_jax():
    jax_graph_ops = {k: JREGISTRY.op(k) for k in JREGISTRY.kinds()
                     if JREGISTRY.op(k).caffe_type}
    graph_ops = [k for k in REGISTRY.kinds() if REGISTRY.op(k).caffe_type]
    assert graph_ops == sorted(jax_graph_ops)
    # the only other op is the serving path's decode attention, whose
    # backends are the JAX package's with 'pallas' named 'cuda'
    assert set(REGISTRY.kinds()) - set(graph_ops) == {"decode_attention"}
    jnames = JREGISTRY.op("decode_attention").backends
    renamed = {{"pallas": "cuda", "pallas_q8": "cuda_q8",
                "paged": "paged_cuda", "paged_q8": "paged_cuda_q8"}.get(n, n)
               for n in jnames}
    assert set(REGISTRY.op("decode_attention").backends) == renamed
    for kind, jspec in jax_graph_ops.items():
        spec = REGISTRY.op(kind)
        assert spec.caffe_type == jspec.caffe_type
        assert spec.inplace == jspec.inplace
        assert "ref" in spec.backends
        # every op with a Pallas kernel has a CUDA one
        assert ("pallas" in jspec.backends) == ("cuda" in spec.backends)


@pytest.mark.parametrize("batch", [1, 8])
def test_shapes_flops_bytes_memory_plan_equal_jax(model, batch):
    _, jg, tg, _, _ = model
    assert tg.shapes() == jg.shapes()
    assert tg.flops(batch) == jg.flops(batch)
    assert tg.bytes_moved(batch) == jg.bytes_moved(batch)
    assert tg.bytes_moved(batch, elem=1) == jg.bytes_moved(batch, elem=1)
    assert tg.memory_plan(batch) == jg.memory_plan(batch)


def test_nin_size_matches_the_paper_network():
    _, tg = graphs("nin-cifar10")
    params = tg.init_params(torch.Generator().manual_seed(0))
    assert sum(v.numel() for g in params.values() for v in g.values()) \
        == 966_986
    assert tg.flops(1) == 445_936_906
    assert [l.kind for l in tg.layers].count("conv") == 9


def test_init_params_deterministic_per_generator():
    _, tg = graphs("lenet-mnist")
    p1 = tg.init_params(torch.Generator().manual_seed(3))
    p2 = tg.init_params(torch.Generator().manual_seed(3))
    for layer in p1:
        for k in p1[layer]:
            assert torch.equal(p1[layer][k], p2[layer][k])


# ---------------------------------------------------------------------------
# Importer: one schema, both directions
# ---------------------------------------------------------------------------


def test_jax_json_doc_imports_into_port(model):
    _, jg, tg, np_params, jparams = model
    doc, weights = jimporter.to_caffe_json(jg, jparams)
    g, params = importer.from_caffe_json(doc, weights)
    assert [(l.kind, l.name) for l in g.layers] == \
        [(l.kind, l.name) for l in jg.layers]
    assert [l.attrs for l in g.layers] == [l.attrs for l in jg.layers]
    for layer, group in np_params.items():
        for k, v in group.items():
            np.testing.assert_array_equal(params[layer][k].numpy(), v)


def test_port_json_doc_imports_into_jax(model):
    _, jg, tg, np_params, _ = model
    tparams = params_from_numpy(np_params, "cpu", graph=tg)
    doc, weights = importer.to_caffe_json(tg, tparams)
    assert doc == jimporter.to_caffe_json(jg)[0]
    g, params = jimporter.from_caffe_json(doc, weights)
    assert g.shapes() == tg.shapes()
    for layer, group in np_params.items():
        for k, v in group.items():
            np.testing.assert_array_equal(np.asarray(params[layer][k]), v)


def test_inline_weights_roundtrip():
    _, tg = graphs("lenet-mnist")
    params = params_from_numpy(numpy_params(tg), "cpu", graph=tg)
    doc, weights = importer.to_caffe_json(tg, params, inline_weights=True)
    assert weights == {}
    g, got = importer.from_caffe_json(doc)
    x = torch.from_numpy(inputs(tg, 2))
    assert_close(g.apply(got, x), tg.apply(params, x), rtol=1e-6)


def test_save_load_model_files(tmp_path):
    _, tg = graphs("nin-cifar10")
    params = params_from_numpy(numpy_params(tg), "cpu", graph=tg)
    importer.save_model(tmp_path / "nin", tg, params)
    g, got = importer.load_model(tmp_path / "nin")
    assert g.shapes() == tg.shapes()
    assert all(torch.equal(got[l][k], params[l][k])
               for l in params for k in params[l])


# ---------------------------------------------------------------------------
# Per-layer parity on carried-over weights
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["ref", "cuda"])
def test_per_layer_parity_with_jax(model, backend):
    """Batch 2, full width.  On the CPU the ``cuda`` backend runs each
    kernel's plain version through the wrappers (im2col + matmul, ...)."""
    _, jg, tg, np_params, jparams = model
    x = inputs(tg, 2)
    want = jax_layers(jg, jparams, jnp.asarray(x))
    trace = []
    out = tg.apply(params_from_numpy(np_params, "cpu", graph=tg),
                   torch.from_numpy(x), backend=backend, trace=trace)
    assert len(trace) == len(want) == len(tg.layers)
    for l, got, ref in zip(tg.layers, trace, want):
        assert tuple(got.shape) == tuple(ref.shape), l.name
        assert_close(got, ref, rtol=1e-4, atol=1e-5, err_msg=l.name)
    np.testing.assert_allclose(out.sum(-1).numpy(), np.ones(2), rtol=1e-5)


# ---------------------------------------------------------------------------
# Weight conversion
# ---------------------------------------------------------------------------


def test_convert_roundtrip_and_qtensor():
    from repro.core.quantize import quantize_tree as jquantize_tree
    _, tg = graphs("lenet-mnist")
    np_params = numpy_params(tg)
    back = params_to_numpy(params_from_numpy(np_params, "cpu", graph=tg))
    for layer, group in np_params.items():
        for k, v in group.items():
            np.testing.assert_array_equal(back[layer][k], v)
    jq = jquantize_tree({l: {k: jnp.asarray(v) for k, v in g.items()}
                         for l, g in np_params.items()})
    tq = params_from_numpy(jq, "cpu", graph=tg)
    w = tq["dense5"]["w"]
    assert w.q.dtype == torch.int8 and w.axis == 1
    np.testing.assert_array_equal(w.q.numpy(), np.asarray(jq["dense5"]["w"].q))
    np.testing.assert_array_equal(params_to_numpy(tq)["dense5"]["w"].scale,
                                  np.asarray(jq["dense5"]["w"].scale))


@pytest.mark.parametrize("mutate,err", [
    (lambda p: p["conv0"].update(w=p["conv0"]["w"].astype(np.float64)),
     TypeError),
    (lambda p: p["conv0"].update(w=p["conv0"]["w"][:, :, :4]), ValueError),
    (lambda p: p["dense5"].update(w=p["dense5"]["w"].T), ValueError),
    (lambda p: p.pop("dense7"), ValueError),
    (lambda p: p["conv0"].pop("b"), ValueError),
])
def test_convert_refuses_mismatch(mutate, err):
    _, tg = graphs("lenet-mnist")
    np_params = numpy_params(tg)
    mutate(np_params)
    with pytest.raises(err):
        params_from_numpy(np_params, "cpu", graph=tg)
