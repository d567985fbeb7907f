"""The port's launch tooling against the JAX package's.

Sharding specs: ``logical_to_spec`` of every parameter leaf of the 10
LM archs under every rule set (train / prefill / decode, single- and
multi-pod, base and perf-optimized) on abstract production meshes,
equal to JAX's.  Input, cache and parameter structs (shapes, dtypes,
logical axes) for every arch and shape, equal to JAX's.  The op cost
model: the ring factors equal JAX's ``analyze_collectives`` on the same
collective records, and a matmul counts 2MNK.  Then, in a subprocess
with a fake process group of 8 ranks: on a pure-data (8, 1) mesh a
reduced step's FLOPs per device are exactly 1/8 of the unsharded count,
and the dry run of reduced TinyLlama and Qwen3-MoE on a (2, 4) mesh
gives every roofline term.  In another subprocess, on a fake group of
256: the full-size dry run of the two pairs that need the RG-LRU's
sharded log-sigmoid (RecurrentGemma-9B ``train_4k``) and the 'bskd'
decode on a slot-split cache (Whisper-medium ``long_500k``).
"""
import json
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import pytest
import torch

from repro import models as jmodels
from repro.configs.base import SHAPES as JSHAPES
from repro.configs.base import get_config as jget_config
from repro.launch import sharding as jshd
from repro.launch.compat import abstract_mesh as jabstract_mesh
from repro.launch.hlo_analysis import (_group_size, _result_bytes,
                                       analyze_collectives)
from repro.models import common as jcm
from repro.sharding_hints import axis_rules as jaxis_rules
from repro.sharding_hints import logical_to_spec as jlogical_to_spec
from repro_torch import models
from repro_torch.configs.base import SHAPES, get_config
from repro_torch.launch import op_costs
from repro_torch.launch import sharding as shd
from repro_torch.launch.compat import abstract_mesh
from repro_torch.launch.dryrun import ARCHS
from repro_torch.models import common as cm
from repro_torch.sharding_hints import axis_rules, logical_to_spec

from test_launch import HLO_SNIPPET


def _norm(spec):
    """A spec entry's 1-tuple and its string are the same split (JAX's
    PartitionSpec stores the string)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _mesh_for(rules, multi_pod):
    shape = rules.pop("_mesh_shape", None) or (16, 16)
    names = ("data", "model")
    if multi_pod:
        shape, names = (2, *shape), ("pod",) + names
    return shape, names


@pytest.mark.parametrize("arch", ARCHS)
def test_logical_to_spec_equals_jax_for_every_param(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    tmpl = dict(_leaves(models.param_template(cfg)))
    jtmpl = dict(_leaves(jmodels.param_template(jcfg)))
    assert tmpl.keys() == jtmpl.keys()
    checked = 0
    for shape_name, shape in SHAPES.items():
        for multi_pod in (False, True):
            for optimized in (False, True):
                rules = shd.rules_for_pair(arch, shape_name, shape.kind,
                                           multi_pod=multi_pod,
                                           optimized=optimized)
                jrules = jshd.rules_for_pair(arch, shape_name, shape.kind,
                                             multi_pod=multi_pod,
                                             optimized=optimized)
                assert rules == jrules
                meshes = {_mesh_for(dict(rules), multi_pod)}
                if not multi_pod:
                    meshes.add(((32, 8), ("data", "model")))
                for sizes, names in meshes:
                    rules.pop("_mesh_shape", None)
                    jrules.pop("_mesh_shape", None)
                    with axis_rules(rules, abstract_mesh(sizes, names)), \
                            jaxis_rules(jrules, jabstract_mesh(sizes, names)):
                        for key, p in tmpl.items():
                            spec = logical_to_spec(p.axes, rules, p.shape)
                            jp = jtmpl[key]
                            jspec = jlogical_to_spec(jp.axes, jrules,
                                                     jp.shape)
                            assert _norm(spec) == _norm(tuple(jspec)), \
                                (arch, shape_name, sizes, key)
                            checked += 1
    assert checked > 0


def _struct(t):
    return tuple(t.shape), str(t.dtype).split(".")[-1]


def _flat_structs(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_structs(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_input_cache_and_param_structs_equal_jax(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    tmpl = models.param_template(cfg)
    jtmpl = jmodels.param_template(jcfg)
    ps = _flat_structs(cm.param_struct(tmpl))
    jps = _flat_structs(jcm.param_struct(jtmpl))
    assert {k: _struct(v) for k, v in ps.items()} == \
        {k: _struct(v) for k, v in jps.items()}
    assert all(v.is_meta for v in ps.values())
    assert _flat_structs(cm.param_axes(tmpl)) == \
        _flat_structs(jcm.param_axes(jtmpl))
    for name, shape in SHAPES.items():
        specs = models.input_specs(cfg, shape)
        jspecs = jmodels.input_specs(jcfg, JSHAPES[name])
        assert specs.keys() == jspecs.keys(), name
        for key in ("batch", "cache"):
            if key in specs:
                got = _flat_structs(specs[key])
                want = _flat_structs(jspecs[key])
                assert {k: _struct(v) for k, v in got.items()} == \
                    {k: _struct(v) for k, v in want.items()}, (name, key)
                assert all(v.is_meta for v in got.values())
        for key in ("batch_axes", "cache_axes"):
            if key in specs:
                assert specs[key] == jspecs[key], (name, key)
        if "pos" in specs:
            assert _struct(specs["pos"]) == _struct(jspecs["pos"])
        if shape.kind == "decode":
            mod, jmod = models.get_module(cfg), jmodels.get_module(jcfg)
            cl = models.cache_len(cfg, shape)
            spec, axes = mod.cache_spec(cfg, 3, cl, torch.bfloat16)
            jspec, jaxes = jmod.cache_spec(jcfg, 3, cl, jnp.bfloat16)
            assert axes == jaxes
            assert {k: (s, str(d).split(".")[-1])
                    for k, (s, d) in spec.items()} == \
                {k: _struct(v) for k, v in jspec.items()}


EXTRA_HLO = """
ENTRY %main (p: f32[64,128]) -> f32[64,128] {
  %p = f32[64,128]{1,0} parameter(0)
  %rs = f32[16,128]{1,0} reduce-scatter(%p), channel_id=3, replica_groups=[2,4]<=[8], dimensions={0}, to_apply=%add
  %a2a = bf16[64,128]{1,0} all-to-all(%p), channel_id=4, replica_groups={{0,1,2,3,4,5,6,7}}, dimensions={0}
  ROOT %ag = f32[64,512]{1,0} all-gather(%p), channel_id=5, replica_groups=[4,2]<=[8], dimensions={1}
}
"""


@pytest.mark.parametrize("hlo", [HLO_SNIPPET, EXTRA_HLO])
def test_ring_factors_equal_jax_analyze_collectives(hlo):
    want = analyze_collectives(hlo, 8)
    got = {}
    for line in hlo.splitlines():
        s = line.strip()
        for kind in op_costs.COLLECTIVE_KINDS:
            if f"{kind}(" in s:
                nbytes, g = _result_bytes(s), _group_size(s, 8)
                got[kind] = got.get(kind, 0.0) + \
                    op_costs.wire_bytes(kind, nbytes, g)
    assert got.keys() == want.keys()
    for kind, st in want.items():
        assert got[kind] == pytest.approx(st["wire_bytes"], rel=1e-12)


def test_op_costs_counts_a_matmul_2mnk():
    m, k, n = 128, 256, 64
    a = torch.empty((m, k), device="meta")
    b = torch.empty((k, n), device="meta")
    with op_costs.OpCosts() as oc:
        a @ b
    assert oc.flops == 2 * m * n * k
    assert oc.bytes == 4 * (m * k + k * n + m * n)
    assert oc.wire_bytes == 0 and oc.ops == 1


def test_trips_count_one_trip_for_all():
    x = torch.empty((8, 16), device="meta")
    w = torch.empty((16, 16), device="meta")
    with op_costs.OpCosts() as once:
        x @ w
    with op_costs.OpCosts() as looped:
        for _ in op_costs.trips(5, True):
            x @ w
    assert looped.flops == 5 * once.flops and looped.bytes == 5 * once.bytes
    assert list(op_costs.trips(3, False)) == [0, 1, 2]


def test_production_mesh_needs_enough_ranks():
    from repro_torch.launch.mesh import make_production_mesh
    with pytest.raises(RuntimeError, match="needs 256 ranks"):
        make_production_mesh()


FAKE = textwrap.dedent("""
    import json, sys
    sys.path.insert(0, "src")
    import torch
    from repro_torch.configs.base import SHAPES, get_config, reduced
    from repro_torch.launch import dryrun as dr
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.compat import make_mesh
    from repro_torch.launch.op_costs import OpCosts
    from repro_torch.sharding_hints import axis_rules

    dr.init_fake_group(8)
    out = {"flops": {}, "dryrun": []}

    def count(cfg, shape, mesh):
        rules = shd.rules_for(shape.kind)
        with axis_rules(rules, mesh):
            fn, structs, shardings = dr.build_step(cfg, shape, rules, mesh)
            args = [shd.distribute(s, p, mesh)
                    for s, p in zip(structs, shardings)]
            with OpCosts() as oc:
                fn(*args)
        return oc.flops

    cfg = reduced(get_config("tinyllama-1.1b"))
    one = make_mesh((1, 1), ("data", "model"), device_type="cuda",
                    devices=[0])
    data8 = make_mesh((8, 1), ("data", "model"), device_type="cuda")
    for name in ("train_4k", "prefill_32k", "decode_32k"):
        out["flops"][name] = [count(cfg, SHAPES[name], data8),
                              count(cfg, SHAPES[name], one)]
    for arch, shape, opt in (("tinyllama-1.1b", "train_4k", False),
                             ("tinyllama-1.1b", "decode_32k", False),
                             ("qwen3-moe-235b-a22b", "train_4k", True),
                             ("qwen3-moe-235b-a22b", "prefill_32k", True)):
        r = dr.dryrun(arch, shape, optimized=opt, verbose=False,
                      cfg=reduced(get_config(arch)), mesh_shape=(2, 4))
        out["dryrun"].append(r)
    print("RESULT " + json.dumps(out))
""")


@pytest.fixture(scope="module")
def fake_group_run():
    r = subprocess.run([sys.executable, "-c", FAKE], capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    line = [l for l in r.stdout.splitlines() if l.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_pure_data_mesh_counts_one_eighth_of_the_flops(fake_group_run,
                                                       shape):
    sharded, whole = fake_group_run["flops"][shape]
    assert whole > 0 and sharded * 8 == whole


def test_dryrun_on_fake_2x4_mesh_gives_every_term(fake_group_run):
    results = fake_group_run["dryrun"]
    assert len(results) == 4
    for r in results:
        assert r["mesh"] == "2x4" and r["chips"] == 8 and r["hw"] == \
            "h100-sxm"
        roof = r["roofline"]
        assert roof["compute_s"] > 0 and roof["memory_s"] > 0
        assert roof["collective_s"] > 0 and r["wire_bytes_per_device"] > 0
        assert roof["bottleneck"] in ("compute", "memory", "collective")
        assert 0 < roof["useful_flops_ratio"]
        ma = r["memory_analysis"]
        assert ma["argument_bytes"] > 0
        assert ma["peak_bytes"] >= ma["argument_bytes"]
        assert ma["temp_bytes"] >= 0
    moe_train = results[2]
    assert moe_train["optimized"] and "all-to-all" in moe_train["collectives"]


C5_PAIRS = [("recurrentgemma-9b", "train_4k"), ("whisper-medium", "long_500k")]

FAKE_FULL = textwrap.dedent("""
    import json, sys
    sys.path.insert(0, "src")
    from repro_torch.launch import dryrun as dr

    dr.init_fake_group(256)
    out = {}
    for arch, shape in %r:
        try:
            out[arch + "/" + shape] = dr.dryrun(arch, shape, verbose=False)
        except Exception as e:
            out[arch + "/" + shape] = {"error": repr(e)}
    print("RESULT " + json.dumps(out))
""" % (C5_PAIRS,))


@pytest.fixture(scope="module")
def full_pairs_run():
    r = subprocess.run([sys.executable, "-c", FAKE_FULL], capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    line = [l for l in r.stdout.splitlines() if l.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


@pytest.mark.parametrize("arch,shape", C5_PAIRS)
def test_full_size_dryrun_of_hybrid_train_and_encdec_long_decode(
        full_pairs_run, arch, shape):
    r = full_pairs_run[f"{arch}/{shape}"]
    assert "error" not in r, r.get("error")
    assert r["mesh"] == "16x16" and r["chips"] == 256
    roof = r["roofline"]
    assert roof["compute_s"] > 0 and roof["memory_s"] > 0
    assert roof["collective_s"] > 0 and r["flops_per_device"] > 0
