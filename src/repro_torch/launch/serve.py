"""Serving driver: load models from a store, batch requests, generate.

    PYTHONPATH=src python -m repro_torch.launch.serve --store /tmp/store \
        --model tinyllama-1.1b --requests 8 --max-new 16

If the store is empty the driver bootstraps it by publishing a
reduced-config model with random weights (so the example is runnable
offline) — the paper's deployment flow: store -> resident cache ->
continuous-batching generation, with hot switching between models.
It runs on the CUDA card; ``--device cpu`` runs it on the CPU.
Generation runs on the slot-based scheduler (device-side sampling,
zero host syncs per token); pass ``--aligned`` to drive the legacy
aligned-batch baseline instead for comparison.

Observability flags:

* ``--metrics-port N`` serves live Prometheus text exposition on
  ``http://127.0.0.1:N/metrics`` (plus ``/healthz``) for the whole run;
  ``--metrics-hold S`` keeps the process (and the endpoint) alive S
  extra seconds after generation so a scraper can catch the final
  state.  Port 0 picks a free port and prints it.
* ``--trace PATH`` records the Chrome trace.  The trace is flushed on
  SIGINT/SIGTERM/exit too, so a killed run still yields a loadable
  file (bounded by the tracer's ``max_events``).
* ``--slo-ttft`` / ``--slo-itl`` set default per-request SLO budgets
  (seconds); the goodput fraction lands in the metrics output.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import models
from repro_torch.checkpoint.ckpt import publish_checkpoint
from repro_torch.configs.base import get_config, reduced as reduce_cfg
from repro_torch.core.modelstore import ModelStore
from repro_torch.runtime.metrics_http import MetricsServer
from repro_torch.runtime.telemetry import Telemetry
from repro_torch.serving.engine import MultiModelServer, Request


def ensure_model(store: ModelStore, arch: str, *, seed: int = 0):
    try:
        store.get(arch)
        return
    except KeyError:
        pass
    cfg = reduce_cfg(get_config(arch))
    params = models.init_params(cfg, torch.Generator().manual_seed(seed))
    rec = publish_checkpoint(store, arch, cfg, params,
                             metadata={"bootstrap": True})
    print(f"bootstrapped {rec.name}:{rec.version} (random reduced weights)")


def pow2_buckets(prompt_len: int):
    """Power-of-two prefill buckets from 4 up to the first that holds
    ``prompt_len`` (the JAX driver's choice, which bounds its compiles;
    kept so that both drivers serve the same computation).  The port's
    scheduler captures one admission graph per bucket."""
    buckets, b = [], 4
    while b < prompt_len:
        buckets.append(b)
        b *= 2
    return buckets + [b]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--store", default="/tmp/repro_store")
    ap.add_argument("--model", action="append", default=None,
                    help="model name(s); repeat to serve several")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default) or 'cpu'")
    ap.add_argument("--aligned", action="store_true",
                    help="use the legacy aligned-batch loop (baseline)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="record request-lifecycle telemetry and export a "
                         "Chrome trace_event JSON here (open in Perfetto); "
                         "flushed on SIGINT/SIGTERM/exit, not just clean "
                         "completion")
    ap.add_argument("--metrics-port", type=int, default=None, metavar="PORT",
                    help="serve live /metrics (Prometheus text exposition) "
                         "and /healthz on this port; 0 picks a free port")
    ap.add_argument("--metrics-hold", type=float, default=0.0, metavar="S",
                    help="keep the metrics endpoint up S seconds after the "
                         "run so an external scraper sees the final state")
    ap.add_argument("--slo-ttft", type=float, default=None, metavar="S",
                    help="default TTFT budget (seconds) for goodput")
    ap.add_argument("--slo-itl", type=float, default=None, metavar="S",
                    help="default inter-token-latency budget (seconds)")
    args = ap.parse_args(argv)
    model_names = args.model or ["tinyllama-1.1b", "qwen3-0.6b"]
    # a Telemetry bundle exists whenever any observability surface is on;
    # metrics-only runs keep the tracer's memory bound tiny
    telemetry = None
    if args.trace or args.metrics_port is not None:
        telemetry = Telemetry()
    if args.trace:
        telemetry.install_flush_on_exit(args.trace)
    metrics_server = None
    if args.metrics_port is not None:
        metrics_server = MetricsServer(telemetry.metrics,
                                       port=args.metrics_port)
        port = metrics_server.start()
        print(f"metrics: http://127.0.0.1:{port}/metrics "
              f"(health: http://127.0.0.1:{port}/healthz)")

    store = ModelStore(args.store)
    for m in model_names:
        ensure_model(store, m)
    server = MultiModelServer(store, max_resident=2,
                              max_batch=args.max_batch,
                              cache_len=args.cache_len,
                              prefill_buckets=pow2_buckets(args.prompt_len),
                              telemetry=telemetry,
                              slo_ttft_s=args.slo_ttft,
                              slo_itl_s=args.slo_itl,
                              device=args.device)
    rng = np.random.default_rng(0)
    uid = 0
    for round_i, name in enumerate(model_names * 2):   # exercise hot swap
        reqs = []
        for _ in range(min(args.requests, args.max_batch)):
            plen = int(rng.integers(4, args.prompt_len + 1))
            reqs.append(Request(uid=uid,
                                prompt=list(rng.integers(1, 255, plen)),
                                max_new_tokens=args.max_new))
            uid += 1
        t0 = time.perf_counter()
        if args.aligned:
            stats = server._engine(name).generate_aligned(reqs)
        else:
            stats = server.serve(reqs, model=name)
        dt = time.perf_counter() - t0
        switch_ms = server.switch_log[-1][1] * 1e3
        print(f"[{round_i}] model={name:20s} reqs={len(reqs)} "
              f"prefill={stats.prefill_s*1e3:7.1f}ms "
              f"decode={stats.decode_s*1e3:7.1f}ms "
              f"{stats.tok_per_s:7.1f} tok/s  switch={switch_ms:6.1f}ms "
              f"(total {dt*1e3:.0f}ms)")
    hits, misses = server.cache.hits, server.cache.misses
    print(f"resident-cache: {hits} hits / {misses} misses "
          f"(resident: {server.cache.resident})")
    if telemetry is not None and args.trace:
        n = telemetry.export_chrome_trace(args.trace)
        ttft = telemetry.metrics.snapshot().get("req.ttft_s", {})
        print(f"trace: {n} events -> {args.trace} "
              f"(TTFT p50={ttft.get('p50', 0)*1e3:.1f}ms "
              f"p99={ttft.get('p99', 0)*1e3:.1f}ms)")
    if telemetry is not None and (args.slo_ttft is not None
                                  or args.slo_itl is not None):
        gp = telemetry.metrics.gauge("slo.goodput").value
        print(f"goodput: {gp:.1%} of requests met their SLO budgets")
    if metrics_server is not None:
        if args.metrics_hold > 0:
            print(f"holding metrics endpoint {args.metrics_hold:.0f}s "
                  f"(ctrl-C to stop)")
            try:
                time.sleep(args.metrics_hold)
            except KeyboardInterrupt:
                pass
        metrics_server.stop()


if __name__ == "__main__":
    main()
