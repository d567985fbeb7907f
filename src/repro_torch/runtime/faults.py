"""Fault-injection harness for the request-lifecycle robustness layer.

The continuous-batching scheduler consults a :class:`FaultInjector` at
its three failure-prone boundaries:

* **page allocation** (``on_alloc``) — returning True makes the
  scheduler behave as if the pool could not supply the pages even after
  LRU prefix eviction, which is exactly the condition that triggers
  preempt-and-requeue mid-decode and admission deferral at admit time;
* **admission** (``on_admission``) — called once per request just
  before its prefill runs, with the scheduler in hand so scripts can
  cancel, inspect, or mutate;
* **step boundaries** (``on_step`` per tick, ``on_suffix_step`` per
  suffix-prefill token of a prefix-cache hit) — the places a deployed
  serving loop receives external events (cancellations, deadline
  sweeps) relative to device work.

Faults are *decisions*, not exceptions: the injector never throws, it
steers the scheduler down its degraded paths so tests can assert the
recovery behavior deterministically — pool-exhaustion-at-step-k,
alloc-failure-during-COW, cancel-during-suffix-prefill — without racing
a real allocator.

No jax imports: pure host Python, usable from any test or benchmark.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.runtime.telemetry import PID_SCHED

__all__ = ["FaultInjector", "AllocFault", "ScriptedFaults"]


class FaultInjector:
    """No-op base class.  Subclass and override the hooks you need; the
    scheduler calls every hook unconditionally when an injector is
    installed, so overrides must stay cheap.

    When the owning scheduler runs with telemetry enabled it points
    :attr:`telemetry` at its own :class:`~repro_torch.runtime.telemetry.Telemetry`
    bundle, so injectors can mark the trace timeline at the exact tick a
    fault fired (``fault.*`` instant events on the scheduler track)."""

    telemetry = None

    def _emit(self, name: str, **args) -> None:
        """Drop a ``fault.<name>`` instant on the scheduler trace track
        (no-op when the scheduler runs without telemetry)."""
        if self.telemetry is not None:
            self.telemetry.tracer.instant(f"fault.{name}", pid=PID_SCHED,
                                          tid=0, cat="fault", args=args)

    def on_alloc(self, site: str, *, tick: int, slot: Optional[int],
                 n: int) -> bool:
        """Called before every page allocation.  ``site`` is one of
        ``"admission"``, ``"first_touch"``, ``"cow"``,
        ``"suffix:first_touch"``, ``"suffix:cow"``.  Return True to
        force the allocation to fail (simulated pool exhaustion)."""
        del site, tick, slot, n
        return False

    def on_admission(self, req, *, tick: int, scheduler) -> None:
        """Called once per request immediately before its admission
        prefill (after it is popped from ``pending``)."""
        del req, tick, scheduler

    def on_step(self, tick: int, scheduler) -> None:
        """Called at the top of every ``tick()``."""
        del tick, scheduler

    def on_suffix_step(self, req, slot: int, i: int, *, tick: int,
                       scheduler) -> None:
        """Called before each suffix-prefill token of a prefix-cache
        hit (``i`` = absolute prompt position about to be computed)."""
        del req, slot, i, tick, scheduler


@dataclass
class AllocFault:
    """One scripted allocation failure rule.

    Matches any allocation whose ``site`` starts with :attr:`site`
    (None matches every site) once the scheduler's tick counter has
    reached :attr:`after_tick`; fires at most :attr:`count` times."""
    site: Optional[str] = None
    after_tick: int = 0
    count: int = 1


class ScriptedFaults(FaultInjector):
    """Deterministic scripting: a list of :class:`AllocFault` rules plus
    optional per-tick and per-suffix-step callbacks.

    ``at_tick`` maps a tick number to a ``callable(scheduler)`` — e.g.
    ``{5: lambda s: s.cancel(3)}`` cancels request 3 at step 5.
    ``on_suffix`` is called as ``fn(scheduler, req, slot, i)`` for every
    suffix-prefill token, which is how tests force
    cancel-during-suffix-prefill.  Every fired fault is appended to
    :attr:`fired` for assertions."""

    def __init__(self, *, alloc: Sequence[AllocFault] = (),
                 at_tick: Optional[Dict[int, Callable]] = None,
                 on_suffix: Optional[Callable] = None):
        self.alloc_rules: List[AllocFault] = list(alloc)
        self.at_tick = dict(at_tick or {})
        self.suffix_fn = on_suffix
        self.fired: List[str] = []

    def on_alloc(self, site: str, *, tick: int, slot: Optional[int],
                 n: int) -> bool:
        for rule in self.alloc_rules:
            if rule.count <= 0 or tick < rule.after_tick:
                continue
            if rule.site is not None and not site.startswith(rule.site):
                continue
            rule.count -= 1
            self.fired.append(f"alloc_fail@{site} tick={tick} "
                              f"slot={slot} n={n}")
            self._emit("alloc_fail", site=site, tick=tick,
                       slot=-1 if slot is None else int(slot), n=int(n))
            return True
        return False

    def on_step(self, tick: int, scheduler) -> None:
        fn = self.at_tick.pop(tick, None)
        if fn is not None:
            self.fired.append(f"action@tick={tick}")
            self._emit("action", tick=tick)
            fn(scheduler)

    def on_suffix_step(self, req, slot: int, i: int, *, tick: int,
                       scheduler) -> None:
        if self.suffix_fn is not None:
            self.suffix_fn(scheduler, req, slot, i)
