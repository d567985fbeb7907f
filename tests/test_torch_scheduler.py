"""Continuous-batching parity: the port's scheduler against the JAX
package's on the same weights and request mix.

Greedy outputs are token-identical and the lifecycle counters equal
(``host_syncs``, ``prefix_hits``, ``cow_copies``, ``preemptions``, the
finish reasons) for: mid-flight admission with more requests than lanes,
device-side stop tokens, cancel and deadlines (mirroring
test_scheduler.py and test_robustness.py); prefill buckets; the int8
ring; the paged layout with prefix hits, copy-on-write forks and no page
leaks, its int8 twin under fault-injected preemption, and admission
deferred under pool pressure (mirroring test_paged.py).  The JAX runs
use its ``ref`` decode attention (its default off a TPU); the port's
take the ``ref`` backend too, which is its default on the CPU.
"""
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.runtime import faults as jfaults
from repro.runtime.scheduler import ContinuousBatchingScheduler as JSched
from repro.runtime.scheduler import Request as JRequest
from repro_torch.configs.base import get_config, reduced
from repro_torch.runtime import faults as tfaults
from repro_torch.runtime.scheduler import ContinuousBatchingScheduler as TSched
from repro_torch.runtime.scheduler import Request as TRequest

from test_torch_transformer import both_params, one_torch_thread  # noqa: F401

COUNTERS = ("host_syncs", "prefix_hits", "cow_copies", "preemptions",
            "admissions", "eos_finishes", "cancellations", "deadline_misses",
            "tokens_generated", "mask_syncs")

# prompts of 14 tokens cross a page boundary (page_size 4) mid-decode
P0 = [3] + [5, 7] * 6 + [11]
P1 = [4] + [5, 7] * 6 + [11]


def _model(arch):
    cfg = reduced(get_config(arch))
    jp, tp = both_params(cfg)
    return jreduced(jget_config(arch)), cfg, jp, tp


@pytest.fixture(scope="module")
def tiny():
    return _model("tinyllama-1.1b")


def _requests(cls, mix):
    return [cls(uid=i, **m) for i, m in enumerate(mix)]


def _run(sched, reqs):
    for r in reqs:
        sched.submit(r)
    sched.run()
    return sched


def run_both(model, mix, *, faults=None, **kw):
    """Run the mix through both schedulers; return (jax requests, port
    requests, jax scheduler, port scheduler).  ``faults(module)`` builds
    each package's injector from its own faults module."""
    jcfg, cfg, jp, tp = model
    kw.setdefault("max_slots", 2)
    kw.setdefault("cache_len", 64)
    kw.setdefault("max_new_cap", 16)
    jreqs, treqs = _requests(JRequest, mix), _requests(TRequest, mix)
    js = _run(JSched(jcfg, jp, faults=faults(jfaults) if faults else None,
                     **kw), jreqs)
    ts = _run(TSched(cfg, tp, faults=faults(tfaults) if faults else None,
                     **kw), treqs)
    return jreqs, treqs, js, ts


def assert_same(jreqs, treqs, js, ts):
    assert [r.output for r in treqs] == [r.output for r in jreqs]
    assert [r.finish_reason for r in treqs] == \
        [r.finish_reason for r in jreqs]
    for name in COUNTERS:
        assert getattr(ts, name) == getattr(js, name), name


MIX = [dict(prompt=[3, 1, 4, 1, 5], max_new_tokens=6),
       dict(prompt=[9, 2, 6], max_new_tokens=8),
       dict(prompt=[5, 3, 5, 8, 9, 7, 9, 3], max_new_tokens=4),
       dict(prompt=[2, 7, 1, 8], max_new_tokens=7),
       dict(prompt=[1, 6, 1, 8, 0, 3], max_new_tokens=5)]


@pytest.fixture(scope="module")
def ring(tiny):
    """The mix on 2 lanes: requests queue and are admitted mid-flight."""
    return run_both(tiny, MIX)


def test_mid_flight_admission_matches_jax(ring):
    jreqs, treqs, js, ts = ring
    assert_same(*ring)
    assert ts.host_syncs == len(MIX)                # one per retirement
    assert ts.mask_syncs == 0
    assert all(len(r.output) == m["max_new_tokens"]
               for r, m in zip(treqs, MIX))


def test_batched_equals_vmapped(tiny, ring):
    _, cfg, _, tp = tiny
    treqs = _requests(TRequest, MIX)
    _run(TSched(cfg, tp, max_slots=2, cache_len=64, max_new_cap=16,
                decode_mode="vmapped"), treqs)
    assert [r.output for r in treqs] == [r.output for r in ring[1]]


def test_stop_tokens_cancel_and_deadline_match_jax(tiny, ring):
    """A request stopping on a token its greedy stream emits, one
    cancelled mid-decode at tick 4, one whose deadline passes in the
    queue."""
    stop = ring[1][0].output[2]
    mix = [dict(MIX[0], stop_tokens=[stop]), dict(MIX[1]),
           dict(MIX[2], deadline_s=0.0), dict(MIX[3]), dict(MIX[4])]

    def faults(mod):
        return mod.ScriptedFaults(at_tick={4: lambda s: s.cancel(1)})
    res = run_both(tiny, mix, faults=faults, eos_check_interval=2)
    assert_same(*res)
    treqs = res[1]
    assert [r.finish_reason for r in treqs] == \
        ["eos", "cancelled", "timeout", "length", "length"]
    assert treqs[0].output == ring[1][0].output[:3]


def test_prefill_buckets_match_jax(tiny):
    assert_same(*run_both(tiny, MIX[:3], prefill_buckets=[4, 8, 16]))


def test_int8_ring_matches_jax(tiny):
    res = run_both(tiny, MIX[:3], kv_dtype="int8")
    assert_same(*res)
    cache = res[3].state["cache"]
    assert cache["k"].dtype == torch.int8
    assert cache["k_scale"].dtype == torch.float32
    assert tuple(cache["k_scale"].shape) == tuple(cache["k"].shape[:4])


def test_paged_prefix_hits_and_cow_forks_match_jax(tiny):
    """Three prompts sharing a 12-token prefix on 2 lanes: the later ones
    map the cached pages, fork them copy-on-write, and leak nothing."""
    base = [7, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11]
    mix = [dict(prompt=base + [20, 21], max_new_tokens=6),
           dict(prompt=base + [30], max_new_tokens=6),
           dict(prompt=base + [40, 41, 42], max_new_tokens=6)]
    res = run_both(tiny, mix, kv_layout="paged", page_size=4)
    assert_same(*res)
    ts = res[3]
    assert ts.prefix_hits >= 1 and ts.cow_copies >= 1
    ts.audit_pages()
    assert ts.pool.available() == res[2].pool.available()
    assert ts.paged_stats()["prefill_tokens_saved"] == \
        res[2].paged_stats()["prefill_tokens_saved"]


def test_paged_int8_preemption_recovers_like_jax(tiny):
    """An injected pool exhaustion at a first-touch page preempts a lane,
    which recomputes to the same greedy output."""
    mix = [dict(prompt=P0, max_new_tokens=8), dict(prompt=P1,
                                                   max_new_tokens=8)]

    def faults(mod):
        return mod.ScriptedFaults(alloc=[mod.AllocFault(site="first_touch",
                                                        after_tick=2)])
    res = run_both(tiny, mix, faults=faults, kv_layout="paged",
                   kv_dtype="int8", page_size=4)
    assert_same(*res)
    assert res[3].preemptions >= 1
    res[3].audit_pages()


def test_admission_defers_under_pool_pressure_like_jax(tiny):
    """A pool that holds one lane's pages: the second request waits for
    the first to retire."""
    mix = [dict(prompt=P0, max_new_tokens=6), dict(prompt=P1,
                                                   max_new_tokens=6)]
    res = run_both(tiny, mix, kv_layout="paged", page_size=4, num_pages=7,
                   cache_len=24, prefix_sharing=False)
    assert_same(*res)
    res[3].audit_pages()


def test_qwen3_ring_matches_jax():
    assert_same(*run_both(_model("qwen3-0.6b"), MIX[:3]))


def test_unknown_attn_backend_rejected(tiny):
    _, cfg, _, tp = tiny
    with pytest.raises(ValueError, match="attn_backend"):
        TSched(cfg, tp, attn_backend="palas")
    with pytest.raises(ValueError, match="kv_dtype"):
        TSched(cfg, tp, kv_dtype="fp8")
    with pytest.raises(ValueError, match="batched"):
        TSched(cfg, tp, kv_dtype="int8", decode_mode="vmapped")


def test_sampling_is_seeded_and_per_lane(tiny):
    """Temperature > 0 draws Gumbel noise from the scheduler's seeded
    generator: the same seed repeats, another seed differs, and a greedy
    lane beside a sampling one keeps its greedy tokens."""
    _, cfg, _, tp = tiny

    def outs(seed):
        reqs = [TRequest(uid=0, prompt=[3, 1, 4], max_new_tokens=8,
                         temperature=1.5),
                TRequest(uid=1, prompt=[3, 1, 4], max_new_tokens=8)]
        _run(TSched(cfg, tp, max_slots=2, cache_len=64, max_new_cap=16,
                    seed=seed), reqs)
        return [r.output for r in reqs]
    a, b, c = outs(0), outs(0), outs(1)
    assert a == b and a[0] != c[0]
    assert a[1] == c[1]
