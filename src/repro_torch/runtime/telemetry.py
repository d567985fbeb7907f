"""Serving telemetry: metrics registry + Chrome-trace request tracing.

The paper's core argument is that inference performance must be
*measured*, not assumed — its GPU-vs-CPU convolution benchmarks are what
justify the Metal implementation.  This module is the measurement
substrate for the serving stack: every later perf item (chunked
prefill, speculative decoding, TP sharding) reports through it.

Three layers, all pure host Python (no jax, no deps):

* :class:`MetricsRegistry` — named :class:`Counter`/:class:`Gauge`/
  :class:`Histogram` instruments.  Histograms are log-bucketed
  (geometric bucket edges), so p50/p90/p99 export costs O(buckets) and
  the relative quantile error is bounded by the bucket growth factor
  (~4.5% at the default ``2**(1/8)``).  The continuous-batching
  scheduler *always* owns a registry — the ad-hoc ``prefill_s`` /
  ``paged_stats()`` counters of earlier PRs are now thin views over it
  — so there is exactly one stats surface.

* :class:`Tracer` — records span ("X"), instant ("i"), async ("b"/"e"),
  counter ("C") and metadata ("M") events and exports Chrome
  ``trace_event`` JSON (``{"traceEvents": [...]}``) that loads directly
  in Perfetto (ui.perfetto.dev) or ``chrome://tracing``.

* :class:`RequestTrace` / :class:`Telemetry` — the opt-in facade the
  scheduler takes as ``telemetry=None | Telemetry()``.  A
  ``RequestTrace`` renders one request's lifecycle (submit → admit →
  prefix hit/miss → first token → preempt/requeue → finish) as one
  async span plus instants on its own trace row; scheduler ticks land
  as nested spans on the scheduler row.

TIMESTAMP SEMANTICS — read before trusting a latency number.  The
scheduler dispatches jitted work asynchronously and never reads device
data per token (the zero-host-syncs-per-token invariant), so host-side
timestamps measure *dispatch*, not device completion:

* ``req.queue_s``    — submit() → the admission loop popping the
  request.  Pure host time; exact.
* ``req.ttft_s``     — submit() → the admission dispatch returning.
  The first token is sampled *inside* the dispatched prefill program,
  so this is a dispatch-anchored lower-bound-ish proxy; because JAX
  enqueues against a busy device stream, dispatch-return tracks device
  completion closely under steady load.
* ``req.itl_s``      — (retirement fetch − first-token dispatch) /
  (tokens − 1), recorded once per inter-token gap.  The retirement
  fetch (and the periodic EOS done-mask fetch) are the scheduler's only
  real sync points, so this amortized number IS anchored to device
  completion at the far end.
* ``req.e2e_s``      — submit() → retirement fetch complete.  Both
  ends are real host events; exact.
* ``sched.tick_s`` / ``sched.step_dispatch_s`` — wall time of one
  tick / of enqueueing the jitted step.  Dispatch cost, NOT device
  step latency; a tick that merely enqueues can be microseconds while
  the device still chews.

None of the above adds a device→host transfer: telemetry-on and
telemetry-off schedulers make byte-identical device traffic (guarded
by ``tests/test_telemetry.py``).
"""
from __future__ import annotations

import atexit
import json
import math
import re
import signal
import time
from contextlib import contextmanager
from typing import Any, Callable, Dict, Iterator, List, Optional

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "Tracer", "RequestTrace", "Telemetry", "prom_name"]

_PROM_INVALID = re.compile(r"[^a-zA-Z0-9_:]")


def prom_name(name: str) -> str:
    """Sanitize a registry name into a legal Prometheus metric name:
    ``sched.finish.eos`` → ``sched_finish_eos``; a leading digit gets a
    ``_`` prefix."""
    out = _PROM_INVALID.sub("_", name)
    if out and out[0].isdigit():
        out = "_" + out
    return out


def _prom_value(v: Any) -> str:
    """Prometheus float rendering (NaN/Inf are legal exposition values)."""
    f = float(v)
    if math.isnan(f):
        return "NaN"
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    return repr(f)


class Counter:
    """Monotonic-by-convention numeric cell (int or float)."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value: Any = 0

    def inc(self, n: Any = 1) -> None:
        self.value += n


class Gauge:
    """Last-write-wins numeric cell."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value: Any = 0

    def set(self, v: Any) -> None:
        self.value = v


class Histogram:
    """Log-bucketed histogram with quantile export.

    Bucket ``i`` covers ``[lo * growth**i, lo * growth**(i+1))``; a
    recorded value's bucket index is recovered with one ``log``.  The
    representative value of a bucket is its geometric midpoint, so any
    quantile is off by at most a factor ``sqrt(growth)`` (~4.5% at the
    default growth ``2**(1/8)``) — plenty for latency percentiles while
    keeping ``record()`` allocation-free on the hot path.

    Values below ``lo`` (including 0) land in a dedicated underflow
    bucket represented by the exact tracked ``min``; values above the
    top edge land in an overflow bucket represented by ``max``.
    """

    __slots__ = ("lo", "growth", "_log_growth", "nbuckets", "counts",
                 "count", "total", "vmin", "vmax")

    def __init__(self, lo: float = 1e-7, hi: float = 1e5,
                 growth: float = 2 ** 0.125) -> None:
        if not (lo > 0 and hi > lo and growth > 1):
            raise ValueError(f"bad histogram shape lo={lo} hi={hi} "
                             f"growth={growth}")
        self.lo = lo
        self.growth = growth
        self._log_growth = math.log(growth)
        self.nbuckets = int(math.ceil(math.log(hi / lo) / self._log_growth))
        self.counts: Dict[int, int] = {}
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    def _index(self, v: float) -> int:
        if v < self.lo:
            return -1                      # underflow (incl. 0, negatives)
        idx = int(math.log(v / self.lo) / self._log_growth)
        return min(idx, self.nbuckets)     # top bucket = overflow

    def record(self, v: float, n: int = 1) -> None:
        """Record ``v`` with multiplicity ``n`` (n>1 lets a retirement
        log all of a request's inter-token gaps in one call)."""
        if n <= 0:
            return
        idx = self._index(float(v))
        self.counts[idx] = self.counts.get(idx, 0) + n
        self.count += n
        self.total += float(v) * n
        self.vmin = min(self.vmin, float(v))
        self.vmax = max(self.vmax, float(v))

    def _bucket_rep(self, idx: int) -> float:
        if idx < 0:
            return self.vmin
        if idx >= self.nbuckets:
            return self.vmax
        lo_edge = self.lo * self.growth ** idx
        return lo_edge * math.sqrt(self.growth)

    def quantile(self, q: float) -> float:
        """The q-quantile (q in [0, 1]); NaN when empty."""
        if self.count == 0:
            return math.nan
        target = q * self.count
        cum = 0
        for idx in sorted(self.counts):
            cum += self.counts[idx]
            if cum >= target:
                rep = self._bucket_rep(idx)
                return min(max(rep, self.vmin), self.vmax)
        return self.vmax

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else math.nan

    def snapshot(self) -> Dict[str, float]:
        return {
            "count": self.count,
            "sum": self.total,
            "mean": self.mean,
            "min": self.vmin if self.count else math.nan,
            "max": self.vmax if self.count else math.nan,
            "p50": self.quantile(0.50),
            "p90": self.quantile(0.90),
            "p99": self.quantile(0.99),
        }


class MetricsRegistry:
    """Named instruments, get-or-create.  The metrics-name catalog the
    serving stack emits is documented in ``docs/serving.md``."""

    def __init__(self) -> None:
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter()
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge()
        return g

    def histogram(self, name: str, **kw) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            h = self._histograms[name] = Histogram(**kw)
        return h

    def counters_with_prefix(self, prefix: str) -> Dict[str, Any]:
        """{suffix: value} for every counter named ``prefix + suffix``."""
        return {k[len(prefix):]: c.value
                for k, c in self._counters.items() if k.startswith(prefix)}

    def reset(self) -> None:
        """Zero every instrument in place (benchmark warmup boundary) —
        instrument identity is preserved so cached references stay live."""
        for c in self._counters.values():
            c.value = 0
        for g in self._gauges.values():
            g.value = 0
        for h in self._histograms.values():
            h.counts.clear()
            h.count = 0
            h.total = 0.0
            h.vmin = math.inf
            h.vmax = -math.inf

    def snapshot(self) -> Dict[str, Any]:
        """One plain-dict view of everything: counters and gauges map to
        their value, histograms to their quantile snapshot."""
        out: Dict[str, Any] = {}
        for k, c in self._counters.items():
            out[k] = c.value
        for k, g in self._gauges.items():
            out[k] = g.value
        for k, h in self._histograms.items():
            out[k] = h.snapshot()
        return out

    def to_prometheus(self) -> str:
        """Text exposition (format 0.0.4, what ``/metrics`` serves).

        Counters export with the conventional ``_total`` suffix; gauges
        as-is; histograms as Prometheus *summaries* — ``{quantile=...}``
        sample lines straight from the log-bucketed quantile estimator
        plus ``_sum``/``_count`` — because the log buckets don't map
        onto fixed ``le=`` edges without lossy re-bucketing.  Names are
        sanitized via :func:`prom_name`; empty histograms export NaN
        quantiles (legal exposition values)."""
        lines: List[str] = []
        for k in sorted(self._counters):
            n = prom_name(k) + "_total"
            lines.append(f"# TYPE {n} counter")
            lines.append(f"{n} {_prom_value(self._counters[k].value)}")
        for k in sorted(self._gauges):
            n = prom_name(k)
            lines.append(f"# TYPE {n} gauge")
            lines.append(f"{n} {_prom_value(self._gauges[k].value)}")
        for k in sorted(self._histograms):
            h = self._histograms[k]
            n = prom_name(k)
            lines.append(f"# TYPE {n} summary")
            for q in (0.5, 0.9, 0.99):
                lines.append(
                    f'{n}{{quantile="{q}"}} {_prom_value(h.quantile(q))}')
            lines.append(f"{n}_sum {_prom_value(h.total)}")
            lines.append(f"{n}_count {h.count}")
        return "\n".join(lines) + "\n"


# -- Chrome trace_event export ----------------------------------------------

PID_SCHED = 1          # scheduler process row: tick/admit/step spans
PID_REQ = 2            # requests process row: one thread per request uid


class Tracer:
    """Chrome ``trace_event`` recorder.

    Timestamps are microseconds since the tracer's construction
    (``time.perf_counter`` based — host wall clock, see the module
    docstring for what that means under async dispatch).  ``max_events``
    bounds memory on runaway runs; overflow is counted, not silent.
    """

    def __init__(self, max_events: int = 1_000_000) -> None:
        self._t0 = time.perf_counter()
        self.events: List[Dict[str, Any]] = []
        self.max_events = max_events
        self.dropped = 0
        self._named_threads: set = set()

    def now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    def _emit(self, ev: Dict[str, Any]) -> None:
        if len(self.events) >= self.max_events:
            self.dropped += 1
            return
        self.events.append(ev)

    def ensure_thread(self, pid: int, tid: int, name: str) -> None:
        """Emit process/thread metadata once per (pid, tid)."""
        if (pid, 0) not in self._named_threads:
            self._named_threads.add((pid, 0))
            self._emit({"ph": "M", "name": "process_name", "pid": pid,
                        "tid": 0, "args": {"name": "scheduler" if
                                           pid == PID_SCHED else "requests"}})
        if (pid, tid) not in self._named_threads:
            self._named_threads.add((pid, tid))
            self._emit({"ph": "M", "name": "thread_name", "pid": pid,
                        "tid": tid, "args": {"name": name}})

    def complete(self, name: str, ts_us: float, dur_us: float, *,
                 pid: int = PID_SCHED, tid: int = 0, cat: str = "sched",
                 args: Optional[Dict] = None) -> None:
        """Complete ("X") event with an explicit start/duration — for
        spans whose start predates knowing whether to record them."""
        self._emit({"ph": "X", "name": name, "cat": cat, "pid": pid,
                    "tid": tid, "ts": ts_us, "dur": dur_us,
                    "args": args or {}})

    @contextmanager
    def span(self, name: str, *, pid: int = PID_SCHED, tid: int = 0,
             cat: str = "sched", args: Optional[Dict] = None
             ) -> Iterator[None]:
        """Complete ("X") event spanning the ``with`` body."""
        t0 = self.now_us()
        try:
            yield
        finally:
            self.complete(name, t0, self.now_us() - t0, pid=pid, tid=tid,
                          cat=cat, args=args)

    def instant(self, name: str, *, pid: int = PID_SCHED, tid: int = 0,
                cat: str = "sched", args: Optional[Dict] = None) -> None:
        self._emit({"ph": "i", "name": name, "cat": cat, "pid": pid,
                    "tid": tid, "ts": self.now_us(), "s": "t",
                    "args": args or {}})

    def async_begin(self, name: str, uid: int, *, pid: int = PID_REQ,
                    tid: int = 0, cat: str = "request",
                    args: Optional[Dict] = None) -> None:
        self._emit({"ph": "b", "name": name, "cat": cat, "id": uid,
                    "pid": pid, "tid": tid, "ts": self.now_us(),
                    "args": args or {}})

    def async_end(self, name: str, uid: int, *, pid: int = PID_REQ,
                  tid: int = 0, cat: str = "request",
                  args: Optional[Dict] = None) -> None:
        self._emit({"ph": "e", "name": name, "cat": cat, "id": uid,
                    "pid": pid, "tid": tid, "ts": self.now_us(),
                    "args": args or {}})

    def counter_event(self, name: str, values: Dict[str, Any], *,
                      pid: int = PID_SCHED) -> None:
        """Perfetto renders these as counter tracks (e.g. free pages)."""
        self._emit({"ph": "C", "name": name, "pid": pid, "tid": 0,
                    "ts": self.now_us(), "args": dict(values)})

    def to_chrome_trace(self) -> Dict[str, Any]:
        events = sorted(self.events, key=lambda e: e.get("ts", 0.0))
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": {"dropped_events": self.dropped}}

    def export(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)
            f.write("\n")

    def reset(self) -> None:
        self.events.clear()
        self._named_threads.clear()
        self.dropped = 0


class RequestTrace:
    """One request's lifecycle rendered onto its own trace row (thread
    ``uid`` of the "requests" process): an async ``lifecycle`` span from
    submit to finish, with instants for every state transition.  The
    scheduler drives these; nothing here touches the device."""

    __slots__ = ("uid", "_tr", "open")

    def __init__(self, uid: int, tracer: Tracer) -> None:
        self.uid = uid
        self._tr = tracer
        self.open = False
        tracer.ensure_thread(PID_REQ, uid, f"req {uid}")

    def _i(self, name: str, **args: Any) -> None:
        self._tr.instant(name, pid=PID_REQ, tid=self.uid, cat="request",
                         args=args)

    def submitted(self, plen: int, max_new: int) -> None:
        if not self.open:       # resubmit after preempt keeps the span
            self._tr.async_begin("lifecycle", self.uid, tid=self.uid,
                                 args={"plen": plen, "max_new": max_new})
            self.open = True
        self._i("submit", plen=plen, max_new=max_new)

    def admitted(self, slot: int, plen: int, queue_s: float) -> None:
        self._i("admit", slot=slot, plen=plen,
                queue_ms=round(queue_s * 1e3, 3))

    def prefix_lookup(self, hit: bool, tokens_saved: int) -> None:
        self._i("prefix_hit" if hit else "prefix_miss",
                tokens_saved=tokens_saved)

    def first_token(self, ttft_s: float) -> None:
        self._i("first_token", ttft_ms=round(ttft_s * 1e3, 3))

    def progressed(self, tokens: int) -> None:
        """Token-progress breadcrumb at a host-known count (anchored at
        dispatch bookkeeping, not device completion)."""
        self._i("progress", tokens=tokens)

    def preempted(self, produced: int) -> None:
        self._i("preempt", produced=produced)

    def finished(self, reason: str, tokens: int) -> None:
        self._i("finish", finish_reason=reason, tokens=tokens)
        if self.open:
            self._tr.async_end("lifecycle", self.uid, tid=self.uid,
                               args={"finish_reason": reason,
                                     "tokens": tokens})
            self.open = False


class Telemetry:
    """The opt-in bundle the scheduler takes: a :class:`MetricsRegistry`
    plus a :class:`Tracer`, with per-uid :class:`RequestTrace` caching.

        tel = Telemetry()
        sched = ContinuousBatchingScheduler(cfg, params, telemetry=tel)
        ... sched.run() ...
        tel.export_chrome_trace("trace.json")   # open in ui.perfetto.dev
        tel.metrics.snapshot()["req.ttft_s"]["p99"]
    """

    def __init__(self, *, metrics: Optional[MetricsRegistry] = None,
                 tracer: Optional[Tracer] = None) -> None:
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.tracer = tracer if tracer is not None else Tracer()
        self._requests: Dict[int, RequestTrace] = {}

    def request(self, uid: int) -> RequestTrace:
        rt = self._requests.get(uid)
        if rt is None:
            rt = self._requests[uid] = RequestTrace(uid, self.tracer)
        return rt

    def export_chrome_trace(self, path: str) -> int:
        """Write the Chrome trace JSON; returns the event count."""
        self.tracer.export(path)
        return len(self.tracer.events)

    def install_flush_on_exit(self, path: str,
                              signals: tuple = (signal.SIGINT,
                                                signal.SIGTERM)
                              ) -> Callable[[], None]:
        """Make a killed run still yield a loadable Chrome trace.

        ``Tracer.export`` normally runs only at a clean end-of-run; this
        registers an ``atexit`` hook plus chaining handlers for the
        given signals so an interrupt (ctrl-C, SIGTERM) flushes whatever
        the bounded event buffer holds (``max_events`` caps the file as
        it caps memory) before the previous handler — KeyboardInterrupt
        included — proceeds.  The flush is idempotent per install:
        signal + atexit won't double-write.

        Returns an ``uninstall()`` callable restoring the previous
        signal handlers (tests use it; servers never need to)."""
        flushed = {"done": False}

        def _flush() -> None:
            if flushed["done"]:
                return
            flushed["done"] = True
            try:
                self.tracer.export(path)
            except OSError:
                pass                     # dying anyway — don't mask the why

        previous = {}
        for sig in signals:
            def _handler(signum, frame, _sig=sig):
                _flush()
                prev = previous.get(_sig)
                if callable(prev):
                    prev(signum, frame)
                elif prev == signal.default_int_handler or \
                        _sig == signal.SIGINT:
                    raise KeyboardInterrupt
                else:
                    signal.signal(_sig, signal.SIG_DFL)
                    signal.raise_signal(_sig)
            try:
                previous[sig] = signal.signal(sig, _handler)
            except (ValueError, OSError):
                pass                     # non-main thread: atexit still fires
        atexit.register(_flush)

        def uninstall() -> None:
            for sig, prev in previous.items():
                try:
                    signal.signal(sig, prev if prev is not None
                                  else signal.SIG_DFL)
                except (ValueError, OSError):
                    pass
            atexit.unregister(_flush)

        return uninstall

    def reset(self) -> None:
        """Warmup boundary: zero metrics and drop recorded events."""
        self.metrics.reset()
        self.tracer.reset()
        self._requests.clear()
