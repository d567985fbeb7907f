"""The twin of ``jax.jit``: ``Graph.jit_apply`` and the scheduler's
captured decode step, held against the JAX package on the CPU.

On the CPU both run eagerly (a CPU tensor never takes a CUDA graph), so
these tests hold what the CPU can show: ``jit_apply`` answers as JAX's
``jit_apply`` does (rtol 1e-3, atol 1e-4, as test_torch_graph.py), the
engines agree through one store artifact, the graph key follows the
weights' addresses, the input shape and the backend, an evicted model's
graphs are dropped, ``disable_graphs()`` nests, the scheduler's tokens
and counters equal JAX's inside and outside ``disable_graphs()``, its
state tensors are never rebound (a captured step reads them by address),
the step's noise is drawn as it was when ``_sample`` drew it, and which
families declare themselves capturable (all five).  For RWKV-6, Whisper,
RecurrentGemma and Granite-MoE (reduced) the scheduler's tokens equal
JAX's inside and outside ``disable_graphs()`` in each cache form the
family serves, and the state of the first three is written in place
through admission, preemption, cancellation and retirement.  Every
flagged family's step (``_advance``, the ``ref`` backend), admission
program, suffix step and closing sample run on fake tensors, where a
host read or a shape that depends on data raises (``FakeTensorMode``);
five host reads are their negative controls.  One admission program and
one suffix program, each run twice on two requests' inputs staged into
the block, give the eager runs of the second: no host value is bound
into a program.  Bucketed schedulers (ring, and paged with a prefix hit)
equal JAX's with the same buckets.  The captures themselves are held on
the card by the ``cuda`` tests in test_torch_cuda.py and by
chip_smoke.py's serve phases.  Weights come from numpy through
``params_from_numpy``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree
from torch._subclasses.fake_tensor import (DataDependentOutputException,
                                           DynamicOutputShapeException,
                                           FakeTensorMode)

from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.core.engine import InferenceEngine as JInferenceEngine
from repro.core.modelstore import ModelStore as JModelStore
from repro.runtime.scheduler import ContinuousBatchingScheduler as JSched
from repro.runtime.scheduler import Request as JRequest
from repro_torch import models
from repro_torch.configs.base import get_config, reduced
from repro_torch.convert import params_from_numpy
from repro_torch.core import importer
from repro_torch.core.engine import InferenceEngine
from repro_torch.core.graph import JitApply, graph_key
from repro_torch.core.jit import disable_graphs, graphs_enabled
from repro_torch.core.modelstore import ModelStore, ResidentCache
from repro_torch.kernels import _build
from repro_torch.models import encdec, moe, rglru, rwkv6, transformer
from repro_torch.runtime import faults as tfaults
from repro_torch.runtime import scheduler as tsched
from repro_torch.runtime.scheduler import ContinuousBatchingScheduler as TSched
from repro_torch.runtime.scheduler import Request as TRequest

import test_torch_encdec
import test_torch_moe
import test_torch_rglru
import test_torch_rwkv6
from conftest import assert_close
from test_torch_graph import MODELS, graphs, inputs, numpy_params
from test_torch_scheduler import (MIX, P0, P1, _model, _requests, _run,
                                  assert_same, run_both, tiny)  # noqa: F401
from test_torch_transformer import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module", params=MODELS)
def cnn(request):
    jg, tg = graphs(request.param)
    np_params = numpy_params(tg, seed=3)
    jparams = {l: {k: jnp.asarray(v) for k, v in g.items()}
               for l, g in np_params.items()}
    return jg, tg, jparams, params_from_numpy(np_params, "cpu", graph=tg)


# ---------------------------------------------------------------------------
# Graph.jit_apply against JAX's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("batch", [1, 2])
def test_jit_apply_matches_jax_jit_apply(cnn, batch):
    jg, tg, jparams, tparams = cnn
    x = inputs(tg, batch, seed=batch)
    want = np.asarray(jg.jit_apply(backend="ref")(jparams, jnp.asarray(x)))
    for backend in ("ref", "cuda"):              # cuda: the plain versions
        fn = tg.jit_apply(backend=backend)
        assert isinstance(fn, JitApply)
        got = fn(tparams, torch.from_numpy(x))
        assert got.is_inference() and tuple(got.shape) == (batch, 10)
        assert_close(got, want, rtol=1e-3, atol=1e-4)
        assert fn._graphs == {}                  # a CPU tensor runs eagerly


def _publish_nin(root, int8):
    jg, tg = graphs("nin-cifar10")
    tparams = params_from_numpy(numpy_params(tg, seed=5), "cpu", graph=tg)
    doc, _ = importer.to_caffe_json(tg, tparams)
    ModelStore(root).publish("nin", doc, tparams, int8=int8)
    return tg


@pytest.mark.parametrize("int8", [False, True])
def test_engines_agree_through_one_artifact(tmp_path, int8):
    """One artifact, both engines' pipelines (JAX's jit_apply, the port's)."""
    tg = _publish_nin(tmp_path, int8)
    x = inputs(tg, 2, seed=9)
    want = JInferenceEngine(JModelStore(tmp_path)).predict("nin", x)
    eng = InferenceEngine(ModelStore(tmp_path), device="cpu")
    got = eng.predict("nin", x)
    assert_close(got, want, rtol=1e-3, atol=1e-4)
    _, _, _, fn = eng.load("nin")
    assert isinstance(fn, JitApply) and fn.kw == {"backend": "ref"}
    assert torch.equal(eng.predict("nin", x), got)


# ---------------------------------------------------------------------------
# The graph key, eviction and disable_graphs()
# ---------------------------------------------------------------------------


def test_graph_key_follows_weights_shape_and_backend(tmp_path):
    tg = _publish_nin(tmp_path, False)
    eng = InferenceEngine(ModelStore(tmp_path), device="cpu")
    _, _, params, fn = eng.load("nin")
    x1, x2 = (torch.from_numpy(inputs(tg, b)) for b in (1, 2))
    key = graph_key(params, x1, fn.kw)
    same = eng.load("nin")[2]                        # the same weights
    assert graph_key(same, x1.clone(), fn.kw) == key
    assert graph_key(params, x2, fn.kw) != key       # a new batch shape
    assert key[0] == (1, 3, 32, 32) and key[1] == torch.float32
    ptrs = [params[l][k].data_ptr() for l in sorted(params)
            for k in sorted(params[l])]
    assert list(key[-1]) == ptrs and len(ptrs) == 18
    assert graph_key(params, x1, {"backend": "cuda"}) != key
    nested = {"backend": {"default": "cuda", "conv": "ref"}}
    assert graph_key(params, x1, nested) == graph_key(
        params, x1, {"backend": {"conv": "ref", "default": "cuda"}})


def test_evict_and_reload_gives_new_key_and_drops_graphs(tmp_path):
    """The resident cache evicts the model's weights: the runtime clears
    its pipeline's graphs, and the reloaded weights (new tensors) key a
    new graph."""
    tg = _publish_nin(tmp_path, False)
    store = ModelStore(tmp_path)
    doc = store.get("nin").load_spec()
    store.publish("other", doc, store.get("nin").load_params())
    eng = InferenceEngine(store, device="cpu", max_resident=1)
    x = torch.from_numpy(inputs(tg, 1))
    _, _, old, fn = eng.load("nin")
    key = graph_key(old, x, fn.kw)
    fn._graphs[key] = "a graph captured on the old weights"
    eng.predict("other", x)                          # evicts nin
    assert eng.cache.resident == [("other", "v1")]
    assert fn._graphs == {}
    _, _, new, fn2 = eng.load("nin")                 # reloaded
    assert fn2 is fn                                 # the same pipeline
    assert graph_key(new, x, fn.kw) != key           # `old` is still alive
    assert_close(eng.predict("nin", x), tg.apply(old, x), rtol=0, atol=0)


def test_resident_cache_reports_evictions(tmp_path):
    _publish_nin(tmp_path, False)
    store = ModelStore(tmp_path)
    store.publish("b", store.get("nin").load_spec(),
                  store.get("nin").load_params())
    gone = []
    cache = ResidentCache(store, capacity=1, on_evict=gone.append)
    cache.get("nin")
    cache.get("nin")
    assert gone == []
    cache.get("b")
    assert gone == [("nin", "v1")]


def test_disable_graphs_nests_and_restores():
    assert graphs_enabled()
    with disable_graphs():
        assert not graphs_enabled()
        with disable_graphs():
            assert not graphs_enabled()
        assert not graphs_enabled()
    assert graphs_enabled()
    with pytest.raises(KeyError):
        with disable_graphs():
            raise KeyError("inside")
    assert graphs_enabled()


def test_recorded_launches_leave_the_counts_until_replayed():
    """A capture's launches run nothing: they leave the counts, and each
    replay adds them back."""
    k1, k2 = _build._KERNELS[0], _build._KERNELS[1]
    n1, n2 = k1.launches, k2.launches
    try:
        with _build.recorded_launches() as held:
            k1.launches += 3                         # what a capture records
            k2.launches += 1
        assert (k1.launches, k2.launches) == (n1, n2)
        assert held == [(k1, 3), (k2, 1)]
        _build.add_launches(held)
        _build.add_launches(held)
        assert (k1.launches, k2.launches) == (n1 + 6, n2 + 2)
    finally:
        k1.launches, k2.launches = n1, n2


# ---------------------------------------------------------------------------
# The scheduler's step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mod,capturable", [
    (transformer, True), (rwkv6, True), (encdec, True), (rglru, True),
    (moe, True)], ids=lambda v: getattr(v, "__name__", "").split(".")[-1]
    or str(v))
def test_capturable_families(tiny, mod, capturable):
    """Every family declares its programs capturable; a CPU scheduler
    never captures."""
    assert getattr(mod, "CUDA_GRAPH_SAFE", False) is capturable
    _, cfg, _, tp = tiny
    sched = TSched(cfg, tp, max_slots=2, cache_len=32, max_new_cap=8)
    assert sched._graphable is False                 # a CPU scheduler


@pytest.mark.parametrize("form", [
    dict(),
    dict(kv_layout="paged", kv_dtype="int8", page_size=4)],
    ids=["ring-fp32", "paged-int8"])
def test_scheduler_inside_and_outside_disable_graphs_matches_jax(tiny, form):
    base = [7, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11]
    mix = MIX[:3] + [dict(prompt=base + [20], max_new_tokens=6),
                     dict(prompt=base + [30, 31], max_new_tokens=5)]
    jreqs, treqs, js, ts = run_both(tiny, mix, **form)
    assert_same(jreqs, treqs, js, ts)
    _, cfg, _, tp = tiny
    with disable_graphs():
        inner = _requests(TRequest, mix)
        ti = _run(TSched(cfg, tp, max_slots=2, cache_len=64, max_new_cap=16,
                         **form), inner)
    assert_same(jreqs, inner, js, ti)
    assert ti.decode_steps == ts.decode_steps > 0
    if form:
        assert ts.prefix_hits >= 1


def test_scheduler_state_is_written_in_place(tiny):
    """A captured step reads the state by address: admission, prefix hits,
    copy-on-write, preemption and retirement write every state tensor in
    place and rebind none."""
    _, cfg, _, tp = tiny
    base = [7, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11]
    mix = [dict(prompt=P0, max_new_tokens=8), dict(prompt=P1,
                                                   max_new_tokens=8),
           dict(prompt=base + [20, 21], max_new_tokens=6),
           dict(prompt=base + [30], max_new_tokens=6),
           dict(prompt=base + [40, 41, 42], max_new_tokens=6)]
    inj = tfaults.ScriptedFaults(alloc=[tfaults.AllocFault(
        site="first_touch", after_tick=2)])
    sched = TSched(cfg, tp, max_slots=2, cache_len=64, max_new_cap=16,
                   kv_layout="paged", kv_dtype="int8", page_size=4,
                   faults=inj)

    def addresses():
        flat = {k: v for k, v in sched.state.items() if k != "cache"}
        flat.update({"cache/" + k: v for k, v in
                     sched.state["cache"].items()})
        return {k: (v.data_ptr(), tuple(v.shape)) for k, v in flat.items()}
    before = addresses()
    noise = sched._noise.data_ptr()
    _run(sched, _requests(TRequest, mix))
    assert sched.preemptions >= 1 and sched.prefix_hits >= 1
    assert sched.cow_copies >= 1
    assert addresses() == before and sched._noise.data_ptr() == noise


def test_step_noise_is_drawn_as_sample_drew_it(tiny):
    """The step draws its Gumbel noise before the step into one buffer,
    outside any graph; the tokens at temperature > 0 are those of the
    step that drew it inside ``_sample`` after the decode."""
    _, cfg, _, tp = tiny

    def old_step(self):
        st = self.state
        self.decode_steps += 1
        last = self._decode_lanes(st["tokens"], st["pos"])
        nxt = tsched._sample(self._generator, last, st["temp"])
        write = st["active"] & (st["out_len"] < st["budget"])
        cols = st["out_len"].clamp(0, self.max_new_cap - 1).long()
        cur = st["out_buf"][self._rows, cols]
        st["out_buf"][self._rows, cols] = torch.where(write, nxt, cur)
        stop_hit = write & (nxt[:, None] == st["stop"]).any(dim=-1)
        st["tokens"].copy_(torch.where(write[:, None], nxt[:, None],
                                       st["tokens"]))
        st["pos"].add_(write.to(torch.int32))
        st["active"].copy_(write & ~stop_hit)
        st["out_len"].add_(write.to(torch.int32))

    def outs(step=None):
        reqs = [TRequest(uid=i, prompt=[3, 1, 4, i], max_new_tokens=8,
                         temperature=t) for i, t in enumerate((1.5, 0.0, 0.7))]
        sched = TSched(cfg, tp, max_slots=2, cache_len=64, max_new_cap=16,
                       seed=11)
        if step is not None:
            sched._step = step.__get__(sched)
        _run(sched, reqs)
        return [r.output for r in reqs], sched.decode_steps
    assert outs() == outs(old_step)


# ---------------------------------------------------------------------------
# RWKV-6, Whisper, RecurrentGemma and Granite-MoE: the scheduler's step,
# captured on a card, runs eagerly here on the same code
# ---------------------------------------------------------------------------

# arch -> (its test module, whose _ragged_run and MIX these tests reuse;
# the cache forms the family serves on the card)
FAMILIES = {"rwkv6-3b": (test_torch_rwkv6, ("ring-fp32",)),
            "whisper-medium": (test_torch_encdec, ("ring-fp32", "paged-int8")),
            "recurrentgemma-9b": (test_torch_rglru,
                                  ("ring-fp32", "paged-int8")),
            "granite-moe-3b-a800m": (test_torch_moe,
                                     ("ring-fp32", "paged-int8"))}
FORMS = {"ring-fp32": {},
         "paged-int8": dict(kv_layout="paged", page_size=16, kv_dtype="int8")}


@functools.lru_cache(maxsize=None)
def _family(arch):
    """(JAX config, port config, JAX params, port params) of the reduced
    arch, the weights made as the family's own test module makes them."""
    cfg = reduced(get_config(arch))
    if arch == "whisper-medium":
        np_params = test_torch_encdec.numpy_params(cfg)
        jp = jax.tree.map(jnp.asarray, np_params)
        tp = params_from_numpy(np_params, "cpu", cfg=cfg)
    else:
        jp, tp = test_torch_rwkv6.both_params(cfg)
    return jreduced(jget_config(arch)), cfg, jp, tp


@functools.lru_cache(maxsize=None)
def _jax_tokens(arch, kv_dtype):
    """The JAX scheduler's ring run of the family's MIX (a paged int8 run
    is held to the ring int8 one, as the family's own tests hold it)."""
    jcfg, _, jp, _ = _family(arch)
    return FAMILIES[arch][0]._ragged_run(JSched, JRequest, jcfg, jp,
                                         kv_dtype=kv_dtype)[0]


@pytest.mark.parametrize("arch,form", [(a, f) for a, (_, forms)
                                       in FAMILIES.items() for f in forms])
def test_family_scheduler_inside_and_outside_disable_graphs_matches_jax(
        arch, form):
    """Mid-flight admission with lanes at ragged positions: greedy tokens
    equal the JAX scheduler's inside and outside ``disable_graphs()``,
    with the same ``decode_steps``."""
    mod = FAMILIES[arch][0]
    _, cfg, _, tp = _family(arch)
    opts = FORMS[form]
    got, sched = mod._ragged_run(TSched, TRequest, cfg, tp, **opts)
    with disable_graphs():
        inner, eager = mod._ragged_run(TSched, TRequest, cfg, tp, **opts)
    assert got == inner == _jax_tokens(arch, opts.get("kv_dtype"))
    assert sched.decode_steps == eager.decode_steps > 0
    assert sched.kv_layout == opts.get("kv_layout", "ring")
    assert sched._graphable is False and sched._graph is None


# per family: the cache form, the faults and the prompts of the in-place
# test.  Whisper pages incrementally, so a failed first-touch allocation
# preempts a lane; RWKV-6 (no pages) and RecurrentGemma (a lane owns its
# whole window) are preempted by a scripted call at tick 4.  RecurrentGemma's
# 40-token prompt prefills past its window of 32 (the roll).
IN_PLACE = {
    "rwkv6-3b": ({}, None),
    "whisper-medium": (FORMS["paged-int8"], tfaults.AllocFault(
        site="first_touch", after_tick=2)),
    "recurrentgemma-9b": (FORMS["paged-int8"], None)}


@pytest.mark.parametrize("arch", list(IN_PLACE))
def test_family_state_is_written_in_place(arch):
    """A captured step reads the state by address: admission,
    preemption, cancellation and retirement write every state and cache
    tensor in place and rebind none; the requests that were not
    cancelled give the tokens of a run without faults."""
    opts, alloc = IN_PLACE[arch]
    _, cfg, _, tp = _family(arch)
    prompts = [[3, 1, 4, 1, 5], list(range(50, 62)), [2, 7, 1, 8],
               list(range(7, 47)) if arch == "recurrentgemma-9b"
               else [9, 9, 8], [6, 5, 4, 3, 2, 1]]

    def run(faults):
        sched = TSched(cfg, tp, max_slots=2, cache_len=48, max_new_cap=12,
                       faults=faults, **opts)
        reqs = [TRequest(uid=i, prompt=list(p), max_new_tokens=10)
                for i, p in enumerate(prompts)]
        return sched, reqs

    at_tick = {7: lambda s: s.cancel(4)}
    if alloc is None:
        at_tick[4] = lambda s: s._preempt_lowest()
    inj = tfaults.ScriptedFaults(alloc=[alloc] if alloc else [],
                                 at_tick=at_tick)
    sched, reqs = run(inj)

    def addresses():
        flat = {k: v for k, v in sched.state.items() if k != "cache"}
        flat.update({"cache/" + k: v for k, v in
                     sched.state["cache"].items()})
        return {k: (v.data_ptr(), tuple(v.shape)) for k, v in flat.items()}
    before = addresses()
    noise = sched._noise.data_ptr()
    _run(sched, reqs)
    assert sched.preemptions >= 1 and sched.cancellations == 1
    assert addresses() == before and sched._noise.data_ptr() == noise
    plain, want = run(None)
    _run(plain, want)
    assert [r.output for r in reqs[:4]] == [r.output for r in want[:4]]
    assert reqs[4].finish_reason == "cancelled"


# ---------------------------------------------------------------------------
# The step on fake tensors: a host read or a data-dependent shape raises
# ---------------------------------------------------------------------------

# every flagged family in the cache forms it serves (RWKV-6 has no pages)
TRACED = [("tinyllama-1.1b", "ring-fp32"), ("tinyllama-1.1b", "paged-int8"),
          ("rwkv6-3b", "ring-fp32")] + [
    (a, f) for a in ("whisper-medium", "recurrentgemma-9b",
                     "granite-moe-3b-a800m")
    for f in ("ring-fp32", "paged-int8")]
TRACE_FORMS = {"ring-fp32": {}, "paged-int8": dict(
    kv_layout="paged", page_size=4, kv_dtype="int8")}
# each raises under FakeTensorMode: the hazards a captured step must not hold
HOST_READS = {"item": lambda t: t.sum().item(),
              "tolist": lambda t: t.tolist(),
              "nonzero": lambda t: t.nonzero(),
              "bool-mask": lambda t: t[t > 0],
              "bincount": lambda t: torch.bincount(t.long())}


def _fake_scheduler(arch, form):
    """A reduced scheduler on the ``ref`` backend whose parameters, state,
    noise and lane rows are fake tensors of a FakeTensorMode (the same
    shapes, dtypes and strides, no data): its ``_advance`` is the step a
    card captures."""
    cfg = reduced(get_config(arch))
    params = models.init_params(cfg, torch.Generator().manual_seed(0))
    sched = TSched(cfg, params, max_slots=2, cache_len=16, max_new_cap=8,
                   attn_backend="ref", prefill_buckets=[8, 24],
                   **TRACE_FORMS[form])
    mode = FakeTensorMode()
    (sched.params, sched.state, sched._noise, sched._rows, sched._in,
     sched._first_noise, sched._suffix_logits) = pytree.tree_map(
        mode.from_tensor,
        (sched.params, sched.state, sched._noise, sched._rows, sched._in,
         sched._first_noise, sched._suffix_logits))
    return sched, mode


@pytest.mark.parametrize("arch,form", TRACED)
def test_flagged_step_runs_on_fake_tensors(arch, form):
    """Every flagged family's step (the dense one as the control) runs
    through the ``ref`` backend on fake tensors: it reads no device value
    on the host and allocates nothing whose shape depends on data (both
    raise in FakeTensorMode), and it leaves every state tensor's shape
    and dtype.  Every op of these steps has a fake (meta) kernel."""
    sched, mode = _fake_scheduler(arch, form)
    meta = pytree.tree_map(lambda t: (tuple(t.shape), t.dtype), sched.state)
    with mode:
        sched._advance()
        sched._advance()
    assert pytree.tree_map(lambda t: (tuple(t.shape), t.dtype),
                           sched.state) == meta


@pytest.mark.parametrize("read", list(HOST_READS))
def test_host_reads_in_a_step_raise_on_fake_tensors(read):
    """The negative controls of the trace test: the same step with one
    host read (or data-dependent shape) added raises."""
    sched, mode = _fake_scheduler("rwkv6-3b", "ring-fp32")
    step = sched._advance

    def with_read():
        HOST_READS[read](sched.state["pos"])
        step()
    with mode, pytest.raises((DataDependentOutputException,
                              DynamicOutputShapeException)):
        with_read()


# the scheduler's other programs, each as it is captured on a card:
# admission of a bucket (24 prefills past RecurrentGemma's window of 16
# here, the roll), the suffix step, its closing sample
PROGRAMS = {"admission": lambda s: s._admission_program(8),
            "suffix": lambda s: s._suffix_program,
            "finalize": lambda s: s._finalize_program}
PROGRAMS_PAST_WINDOW = {
    "admission-24": lambda s: s._admission_program(24)}


@pytest.mark.parametrize("arch,form,program", [
    (a, f, p) for a, f in TRACED for p in PROGRAMS] + [
    ("recurrentgemma-9b", f, "admission-24")
    for f in ("ring-fp32", "paged-int8")])
def test_flagged_programs_run_on_fake_tensors(arch, form, program):
    """Every flagged family's admission program (prefill, cast, first
    sample, splice, lane scalars: Whisper's encoder over its frames,
    RecurrentGemma's roll past the window), suffix step and closing
    sample run twice through the ``ref`` backend on fake tensors, reading
    every input from the (fake) block: no host read, no shape that
    depends on data, every state tensor's shape and dtype left."""
    sched, mode = _fake_scheduler(arch, form)
    meta = pytree.tree_map(lambda t: (tuple(t.shape), t.dtype), sched.state)
    with mode:
        run = {**PROGRAMS, **PROGRAMS_PAST_WINDOW}[program](sched)
        run()
        run()
    assert pytree.tree_map(lambda t: (tuple(t.shape), t.dtype),
                           sched.state) == meta


@pytest.mark.parametrize("program", list(PROGRAMS))
@pytest.mark.parametrize("read", list(HOST_READS))
def test_host_reads_in_a_program_raise_on_fake_tensors(read, program):
    """The negative controls of the programs' trace: each program with
    one host read of its input block added raises."""
    sched, mode = _fake_scheduler("tinyllama-1.1b", "paged-int8")
    run = PROGRAMS[program](sched)

    def with_read():
        HOST_READS[read](sched._inputs()["slot"])
        run()
    with mode, pytest.raises((DataDependentOutputException,
                              DynamicOutputShapeException)):
        with_read()


# ---------------------------------------------------------------------------
# A program run again on new inputs: no host value is bound into it
# ---------------------------------------------------------------------------

REPLAY_FORMS = {"ring-fp32": {},
                "paged-int8": dict(kv_layout="paged", page_size=4,
                                   kv_dtype="int8")}


def _lane(sched, lane):
    """Lane ``lane``'s state and cache (paged: its table row and the
    pool pages it maps), as plain tensors."""
    st = sched.state
    out = {k: v[lane].clone() for k, v in st.items() if k != "cache"}
    cache = st["cache"]
    if "page_table" in cache:
        row = cache["page_table"][lane].long()
        out["page_table"] = row.clone()
        out.update({k: v[:, row].clone() for k, v in cache.items()
                    if k.endswith("_pages")})
    else:
        out.update({k: v[:, lane].clone() for k, v in cache.items()})
    return out


@pytest.mark.parametrize("form", list(REPLAY_FORMS))
def test_admission_program_run_again_gives_the_eager_admission(tiny, form):
    """One admission program of padded length 8, run for request A on
    lane 0 (sampled at 0.9, a stop token, pages 1-2) and then, with B's
    inputs staged into the block, run again for B on lane 1 (greedy,
    another budget, pages 3-4): lane 1 equals a fresh scheduler's eager
    admission of B, and lane 0 keeps A's.  A slot, temperature, budget,
    stop row, page or prompt bound into the program would show here."""
    _, cfg, _, tp = tiny
    opts = REPLAY_FORMS[form]

    def sched():
        return TSched(cfg, tp, max_slots=2, cache_len=32, max_new_cap=8,
                      prefill_buckets=[8], **opts)

    def padded(prompt):
        row = np.zeros((1, 8), np.int32)
        row[0, 8 - len(prompt):] = prompt
        return row
    a = TRequest(uid=0, prompt=[3, 1, 4, 1, 5], max_new_tokens=5,
                 temperature=0.9, stop_tokens=[7])
    b = TRequest(uid=1, prompt=[9, 2, 6, 5, 3, 5, 8], max_new_tokens=7)
    pages = {0: [1, 2], 1: [3, 4]} if opts else {0: None, 1: None}
    s = sched()
    run = s._admission_program(8)
    for lane, req in ((0, a), (1, b)):
        s._stage_lane(lane, req, 8, toks=padded(req.prompt)[0],
                      pages=pages[lane])
        s._first_noise.uniform_(generator=s._generator)
        run()
    a_alone, b_alone = sched(), sched()
    a_alone._admit(padded(a.prompt), 0, a, pages[0])
    b_alone._admit(padded(b.prompt), 1, b, pages[1])
    got, want = _lane(s, 1), _lane(b_alone, 1)
    assert got.keys() == want.keys()
    for k in got:
        assert torch.equal(got[k], want[k]), k
    assert int(got["pos"]) == 8 and int(got["budget"]) == 7
    assert float(got["temp"]) == 0.0 and bool(got["active"])
    kept = _lane(s, 0)
    assert float(kept["temp"]) == pytest.approx(0.9)
    assert kept["stop"].tolist()[0] == 7 and int(kept["budget"]) == 5
    for k in ("tokens", "pos", "budget", "stop"):
        assert torch.equal(kept[k], _lane(a_alone, 0)[k]), k


def test_suffix_program_run_again_gives_the_eager_step(tiny):
    """One suffix program run for (token 11, lane 0, its position) and
    again, with new inputs staged, for (token 12, lane 1, its position):
    each time the lane's logits and the cache equal the eager suffix
    step's (the lane's token and position replaced in copies of the
    state, the batched decode, the lane's row)."""
    _, cfg, _, tp = tiny
    opts = REPLAY_FORMS["paged-int8"]

    def admitted():
        s = TSched(cfg, tp, max_slots=2, cache_len=32, max_new_cap=8,
                   **opts)
        for i, p in enumerate(([3, 1, 4, 1, 5], [9, 2, 6])):
            s.submit(TRequest(uid=i, prompt=p, max_new_tokens=6))
        s.tick()
        return s

    def eager(s, tok, lane, pos):
        tokens = s.state["tokens"].clone()
        tokens[lane, 0] = tok
        pos_v = s.state["pos"].clone()
        pos_v[lane] = pos
        return s._decode_lanes(tokens, pos_v)[lane]
    s, ref = admitted(), admitted()
    run = s._suffix_program
    for tok, lane in ((11, 0), (12, 1)):
        pos = int(s._host_pos[lane])
        s._stage_suffix(tok, lane, pos)
        run()
        want = eager(ref, tok, lane, pos)
        assert torch.equal(s._suffix_logits, want.float())
        for k, v in s.state["cache"].items():
            assert torch.equal(v, ref.state["cache"][k]), k


# ---------------------------------------------------------------------------
# Bucketed schedulers (admission captured per bucket on a card) against
# JAX's with the same buckets
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _granite():
    return _model("granite-moe-3b-a800m")


@pytest.mark.parametrize("form", [
    dict(), dict(kv_layout="paged", kv_dtype="int8", page_size=4)],
    ids=["ring-fp32", "paged-int8"])
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "granite-moe-3b-a800m"])
def test_bucketed_scheduler_inside_and_outside_disable_graphs_matches_jax(
        tiny, arch, form):
    """Prefill buckets 4, 8, 16, 32 on 2 lanes: two 13-token prompts that
    share 12 tokens fall in bucket 16 (on pages of 4 a prefix hit, its
    suffix fed through the suffix step), the rest in 4 and 8; greedy
    tokens and counters equal the JAX scheduler's with the same buckets,
    inside and outside ``disable_graphs()``."""
    model = tiny if arch == "tinyllama-1.1b" else _granite()
    base = [7, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11]
    mix = MIX[:3] + [dict(prompt=base + [20], max_new_tokens=6),
                     dict(prompt=base + [30], max_new_tokens=5)]
    kw = dict(prefill_buckets=[4, 8, 16, 32], **form)
    jreqs, treqs, js, ts = run_both(model, mix, **kw)
    assert_same(jreqs, treqs, js, ts)
    _, cfg, _, tp = model
    with disable_graphs():
        inner = _requests(TRequest, mix)
        ti = _run(TSched(cfg, tp, max_slots=2, cache_len=64, max_new_cap=16,
                         **kw), inner)
    assert_same(jreqs, inner, js, ti)
    assert ti.decode_steps == ts.decode_steps > 0
    assert ts._graphs == {} and ti._graphs == {}
    if form:
        assert ts.prefix_hits >= 1


def test_a_prompt_past_the_block_reads_a_block_of_its_own():
    """A wrap-safe family's prompt longer than the input block's room
    (past the top bucket, so admitted eagerly) is staged into a block of
    its own: the scheduler's block, which captured programs read by
    address, is kept, and the tokens equal those of a scheduler whose
    block holds the prompt (RWKV-6's state does not depend on
    cache_len)."""
    _, cfg, _, tp = _family("rwkv6-3b")
    prompts = [[3, 1, 4], list(range(5, 35)), [2, 7, 1, 8, 2]]

    def run(cache_len):
        sched = TSched(cfg, tp, max_slots=2, cache_len=cache_len,
                       max_new_cap=8, prefill_buckets=[4, 8])
        reqs = [TRequest(uid=i, prompt=p, max_new_tokens=6)
                for i, p in enumerate(prompts)]
        block = sched._in
        _run(sched, reqs)
        assert sched._in is block
        return sched, [r.output for r in reqs]
    sched, got = run(16)
    assert sched._in.numel() < sched._in_at["toks"] + 30
    roomy, want = run(64)
    assert roomy._in.numel() >= roomy._in_at["toks"] + 30
    assert got == want
