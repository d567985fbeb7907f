"""Serving engines: continuous-batching generation + hot model swap.

The port of ``repro.serving.engine``:

  * :class:`ServingEngine` fronts one model.  Generation goes through
    ``repro_torch.runtime.scheduler.ContinuousBatchingScheduler``: slot-based
    continuous batching, sampling on the device, mid-flight admission and
    retirement, zero host syncs per generated token.  The aligned-batch
    loop survives as ``generate_aligned``, the baseline.
  * :class:`MultiModelServer` is a store-backed
    ``repro_torch.runtime.base.DeviceRuntime``: requests resolve through
    the LRU ``ResidentCache`` (a warm swap copies no weights), optionally
    routed by a selector, then generate on the chosen model's engine.

Both run on the CUDA device unless the caller passes ``device="cpu"``;
with no CUDA device they raise.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import models
from repro_torch.configs.base import ArchConfig
from repro_torch.core.modelstore import ModelStore
from repro_torch.runtime.base import DeviceRuntime, resolve_device
from repro_torch.runtime.scheduler import (ContinuousBatchingScheduler,
                                           Request, _sample)

__all__ = ["Request", "GenStats", "ServingEngine", "MultiModelServer"]


@dataclass
class GenStats:
    prefill_s: float = 0.0
    decode_s: float = 0.0
    tokens_out: int = 0

    @property
    def tok_per_s(self):
        return self.tokens_out / self.decode_s if self.decode_s else 0.0


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


class ServingEngine:
    """Single-model engine fronting the continuous-batching scheduler.
    ``params`` move to ``device`` (a no-op when they are there)."""

    def __init__(self, cfg: ArchConfig, params, *, max_batch: int = 8,
                 cache_len: int = 256, pad_id: int = 0, seed: int = 0,
                 prefill_buckets: Optional[List[int]] = None,
                 decode_mode: str = "batched",
                 attn_backend: Optional[str] = None,
                 kv_dtype: Optional[str] = None,
                 kv_layout: str = "ring", page_size: int = 16,
                 num_pages: Optional[int] = None,
                 prefix_sharing: bool = True,
                 eos_id: Optional[int] = None,
                 max_stop_tokens: int = 4,
                 eos_check_interval: int = 8,
                 watchdog_ticks: int = 256,
                 faults=None, telemetry=None,
                 slo_ttft_s: Optional[float] = None,
                 slo_itl_s: Optional[float] = None,
                 device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = _to_device(params, self.device)
        self.mod = models.get_module(cfg)
        self.max_batch = max_batch
        self.cache_len = cache_len
        self.pad_id = pad_id
        self.seed = seed
        self.prefill_buckets = prefill_buckets
        self.decode_mode = decode_mode
        self.attn_backend = attn_backend
        self.kv_dtype = kv_dtype
        self.kv_layout = kv_layout
        self.page_size = page_size
        self.num_pages = num_pages
        self.prefix_sharing = prefix_sharing
        self.eos_id = eos_id
        self.max_stop_tokens = max_stop_tokens
        self.eos_check_interval = eos_check_interval
        self.watchdog_ticks = watchdog_ticks
        self.faults = faults
        self.telemetry = telemetry
        self.slo_ttft_s = slo_ttft_s
        self.slo_itl_s = slo_itl_s
        self._sched: Optional[ContinuousBatchingScheduler] = None
        # sampling state of the aligned baseline
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(seed)

    # -- continuous batching (the serving path) -----------------------------

    def scheduler(self, *, max_new_cap: int = 0
                  ) -> ContinuousBatchingScheduler:
        """The engine's resident scheduler, (re)built only when a request
        needs a larger output buffer than the current one has."""
        if self._sched is None or self._sched.max_new_cap < max_new_cap:
            pending = []
            if self._sched is not None:
                if any(r is not None for r in self._sched.slots):
                    raise RuntimeError(
                        "cannot grow max_new_cap while requests are in "
                        "flight — drain the scheduler first")
                pending = list(self._sched.pending)  # carry queued requests
            cap = _next_pow2(max(max_new_cap,
                                 self._sched.max_new_cap if self._sched
                                 else 0, 16))
            self._sched = None            # free the old cache first
            self._sched = ContinuousBatchingScheduler(
                self.cfg, self.params, max_slots=self.max_batch,
                cache_len=self.cache_len, max_new_cap=cap,
                pad_id=self.pad_id, seed=self.seed,
                prefill_buckets=self.prefill_buckets,
                decode_mode=self.decode_mode,
                attn_backend=self.attn_backend, kv_dtype=self.kv_dtype,
                kv_layout=self.kv_layout, page_size=self.page_size,
                num_pages=self.num_pages,
                prefix_sharing=self.prefix_sharing, eos_id=self.eos_id,
                max_stop_tokens=self.max_stop_tokens,
                eos_check_interval=self.eos_check_interval,
                watchdog_ticks=self.watchdog_ticks, faults=self.faults,
                telemetry=self.telemetry, slo_ttft_s=self.slo_ttft_s,
                slo_itl_s=self.slo_itl_s)
            self._sched.pending.extend(pending)
        return self._sched

    def cancel(self, uid: int) -> bool:
        """Cancel a submitted request by uid (see scheduler.cancel)."""
        if self._sched is None:
            return False
        return self._sched.cancel(uid)

    def generate_batch(self, requests: List[Request]) -> GenStats:
        """Run requests to completion through the continuous scheduler;
        more requests than ``max_batch`` queue and are admitted as lanes
        retire."""
        if not requests:
            return GenStats()
        sched = self.scheduler(
            max_new_cap=max(r.max_new_tokens for r in requests))
        p0, d0, t0 = sched.prefill_s, sched.decode_s, sched.tokens_generated
        for r in requests:
            sched.submit(r)
        sched.run()
        return GenStats(prefill_s=sched.prefill_s - p0,
                        decode_s=sched.decode_s - d0,
                        tokens_out=sched.tokens_generated - t0)

    # -- aligned-batch baseline ----------------------------------------------

    def generate_aligned(self, requests: List[Request]) -> GenStats:
        """The pre-scheduler loop: aligned batch, one global temperature,
        one host sync per token, ring caches that wrap past
        ``cache_len``."""
        if len(requests) > self.max_batch:
            raise ValueError(f"{len(requests)} requests > max_batch "
                             f"{self.max_batch}")
        stats = GenStats()
        b = len(requests)
        plen = max(len(r.prompt) for r in requests)
        toks = np.full((b, plen), self.pad_id, np.int64)
        for i, r in enumerate(requests):
            toks[i, plen - len(r.prompt):] = r.prompt   # left-pad
        temp = torch.full((b,), float(requests[0].temperature),
                          device=self.device)
        t0 = time.perf_counter()
        logits, cache = self.mod.prefill(
            self.cfg, self.params, torch.from_numpy(toks).to(self.device),
            self.cache_len, cache_dtype=torch.float32)
        last = logits[:, -1]
        stats.prefill_s = time.perf_counter() - t0
        pos = plen
        max_new = max(r.max_new_tokens for r in requests)
        t0 = time.perf_counter()
        for _ in range(max_new):
            nxt = _sample(self._generator, last, temp)
            nxt_host = nxt.cpu().numpy()                # host sync per token
            for i, r in enumerate(requests):
                if not r.done and len(r.output) < r.max_new_tokens:
                    r.output.append(int(nxt_host[i]))
                    stats.tokens_out += 1
                    if len(r.output) >= r.max_new_tokens:
                        r.done = True
            if all(r.done for r in requests):
                break
            lg, cache = self.mod.decode_step(self.cfg, self.params,
                                             nxt[:, None], cache, pos)
            last = lg[:, 0]
            pos += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        stats.decode_s = time.perf_counter() - t0
        return stats


class MultiModelServer(DeviceRuntime):
    """Store-backed server: context -> (selected) model -> generate, on
    the shared ``DeviceRuntime`` residency/stats substrate."""

    def __init__(self, store: ModelStore, *, max_resident: int = 2,
                 selector=None, device="cuda", **engine_kw):
        super().__init__(store, max_resident=max_resident, device=device)
        self.selector = selector
        self.engine_kw = engine_kw
        self._engines: Dict[Tuple[str, str], ServingEngine] = {}

    def _engine(self, name: str, version: Optional[str] = None):
        rec, spec, params = self.activate(name, version)
        key = (rec.name, rec.version)
        if key not in self._engines:
            cfg = ArchConfig(**spec["arch"])
            self._engines[key] = ServingEngine(cfg, params, device=self.device,
                                               **self.engine_kw)
        return self._engines[key]

    def serve(self, requests: List[Request], *, model: Optional[str] = None,
              context_feats=None) -> GenStats:
        if model is None:
            if self.selector is None or context_feats is None:
                raise ValueError("serve: pass model=, or a selector and "
                                 "context_feats")
            model = self.selector.select(context_feats, k=1)[0]
        return self._engine(model).generate_batch(requests)
