"""Slot-based continuous-batching decode scheduler.

The port of ``repro.runtime.scheduler``.  ``max_slots`` decode lanes stay
resident on the device, and ALL per-token state (last token, per-lane
position, temperature, active mask, budget, output buffer, stop sets and
the KV cache) lives in one dict of device tensors that the programs below
update in place where the JAX package rebuilds a pytree.  One step
advances every lane: the family's lane-major ``decode_step_batch`` (one
fused ragged decode-attention call per layer, the backend resolved by
name through the op registry: ``ref`` = plain tensor ops, ``cuda`` = the
flash-decode kernel), then sampling on the device (argmax where a lane's
temperature is 0, Gumbel-max from a device ``torch.Generator``
elsewhere), then the scatter into the output buffer.

The host loop only dispatches and keeps the slot bookkeeping it can
derive without reading device memory (``_host_pos``, ``_pt_host``,
``_host_valid`` and ``_steps_left`` decide everything), so a generated
token costs zero host syncs; the one device->host transfer per retired
request goes through pinned memory at retirement and is counted in
``host_syncs``.  The JAX package jits its programs; here, on a CUDA
device and for a family that declares itself capturable
(``CUDA_GRAPH_SAFE``: the dense transformer, the MoE, RWKV-6, the
encoder-decoder and the RG-LRU hybrid), they are CUDA graphs
(``repro_torch.core.jit``): the decode step is captured once per
scheduler and replayed at every tick, the prefix-hit suffix step and
its closing sample once per scheduler, and admission (prefill, the
splice, the lane scalars) once per prefill bucket, as JAX compiles one
per static ``plen``.  Every input of a captured program is staged into
one block of device inputs before it runs (one non-blocking copy from
pinned memory).  The page-table programs, an admission without buckets
or past the top bucket, and ``decode_mode='vmapped'`` run eagerly.

Everything else is the JAX package's, unchanged: mid-flight admission,
prompt-length buckets (left padding, pads attended), the ring and paged
KV layouts with prefix sharing and copy-on-write, recompute preemption,
device-side stop sets with the periodic done-mask fetch, deadlines and
cancel, the no-progress watchdog, the fault-injection hooks, telemetry,
and the roofline and SLO statistics.  ``decode_mode='vmapped'`` (the
correctness reference) becomes a loop of B=1 ``decode_step`` calls over
the lanes.  Only greedy sampling is held to token parity with the JAX
package: Gumbel-max cannot reproduce ``jax.random``.
"""
from __future__ import annotations

import math
import time
from collections import deque, namedtuple
from contextlib import nullcontext
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch import models
from repro_torch.configs.base import ArchConfig
from repro_torch.core.jit import Captured, capture, graphs_enabled
from repro_torch.models import common as cm
from repro_torch.runtime.faults import FaultInjector
from repro_torch.runtime.pagepool import GARBAGE_PAGE, PagePool
from repro_torch.runtime.roofline import HWSpec, RooflineAccountant
from repro_torch.runtime.telemetry import (PID_SCHED, MetricsRegistry, Telemetry)

FreeCapacity = namedtuple("FreeCapacity", ["lanes", "pages"])


@dataclass
class Request:
    uid: int
    prompt: List[int]
    max_new_tokens: int = 16
    temperature: float = 0.0
    output: List[int] = field(default_factory=list)
    done: bool = False
    submitted_at: float = 0.0
    finished_at: float = 0.0
    # lifecycle: extra per-request stop tokens (union'd with the
    # scheduler's eos_id), an optional wall-clock deadline measured from
    # submit(), and how the request ended —
    # "eos" | "length" | "cancelled" | "timeout"
    stop_tokens: Optional[List[int]] = None
    deadline_s: Optional[float] = None
    finish_reason: Optional[str] = None
    # telemetry: when the admission dispatch that sampled the first token
    # returned (host clock); survives preemption so TTFT is recorded
    # once.  ``diagnostics``: a scheduler-state snapshot attached on
    # cancel / timeout retirement.
    first_token_at: float = 0.0
    diagnostics: Optional[Dict[str, Any]] = None
    # SLO budgets in seconds (None = the scheduler-level defaults)
    slo_ttft_s: Optional[float] = None
    slo_itl_s: Optional[float] = None


def _sample(generator: torch.Generator, logits, temp, u=None):
    """Greedy where temp == 0, Gumbel-max elsewhere — per row, on the
    device, with no host read.  ``argmax`` returns the first maximal
    index, as ``jnp.argmax`` does.  ``u``, uniform noise of ``logits``'
    shape, is drawn from ``generator`` unless the caller drew it."""
    logits = logits.float()
    greedy = logits.argmax(dim=-1)
    if u is None:
        u = torch.rand(logits.shape, generator=generator,
                       device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp(1e-10, 1.0 - 1e-7)))
    scaled = logits / torch.clamp_min(temp, 1e-6)[:, None]
    sampled = (scaled + gumbel).argmax(dim=-1)
    return torch.where(temp > 0.0, sampled, greedy).to(torch.int32)


class ContinuousBatchingScheduler:
    """Continuous batching over any family exposing prefill/decode_step.

    Host-side bookkeeping (which slot serves which request, how many
    tokens it has produced) is derivable without device reads, so the
    decode loop never blocks on the device.  ``host_syncs`` counts the
    transfers that DO happen — exactly one per retired request.  The
    device is the one the parameters live on.
    """

    def __init__(self, cfg: ArchConfig, params, *, max_slots: int = 8,
                 cache_len: int = 256, max_new_cap: int = 64,
                 pad_id: int = 0, seed: int = 0,
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
                 faults: Optional[FaultInjector] = None,
                 telemetry: Optional[Telemetry] = None,
                 slo_ttft_s: Optional[float] = None,
                 slo_itl_s: Optional[float] = None,
                 hw: Optional[HWSpec] = None):
        self.cfg = cfg
        self.params = params
        self.device = params["embed"].device
        self.mod = models.get_module(cfg)
        # the MetricsRegistry always exists (the one stats surface behind
        # prefill_s/decode_s, paged_stats() and lifecycle_stats());
        # telemetry=None only keeps the tracer off
        self.telemetry = telemetry
        self.metrics = telemetry.metrics if telemetry is not None \
            else MetricsRegistry()
        if telemetry is not None:
            telemetry.tracer.ensure_thread(PID_SCHED, 0, "ticks")
        self._last_tick_s = 0.0
        self.max_slots = max_slots
        self.cache_len = cache_len
        self.max_new_cap = max_new_cap
        self.pad_id = pad_id
        self.prefill_buckets = sorted(prefill_buckets) if prefill_buckets \
            else None
        if decode_mode not in ("batched", "vmapped"):
            raise ValueError(f"unknown decode_mode {decode_mode!r}")
        if decode_mode == "batched" and \
                not hasattr(self.mod, "decode_step_batch"):
            decode_mode = "vmapped"
        self.decode_mode = decode_mode
        # kv_dtype: None keeps the f32 cache; 'bf16' halves KV bytes;
        # 'int8' quarters them (per-slot scales + the *_q8 attention)
        if kv_dtype not in (None, "bf16", "int8"):
            raise ValueError(f"unknown kv_dtype {kv_dtype!r} "
                             "(expected None, 'bf16' or 'int8')")
        if kv_dtype == "int8" and decode_mode != "batched":
            raise ValueError(
                "kv_dtype='int8' requires decode_mode='batched' — the "
                "single-token decode_step has no quantized cache path")
        self.kv_dtype = kv_dtype
        # kv_layout='paged': a global pool of fixed-size pages behind a
        # (B, W) page table, refcounted host-side, with copy-on-write
        # shared-prefix reuse.  Families without ``paged_info`` keep the
        # ring layout.
        if kv_layout not in ("ring", "paged"):
            raise ValueError(f"unknown kv_layout {kv_layout!r} "
                             "(expected 'ring' or 'paged')")
        self.page_size = page_size
        self._paged = False
        self.pool: Optional[PagePool] = None
        if kv_layout == "paged" and hasattr(self.mod, "paged_info"):
            if decode_mode != "batched":
                raise ValueError(
                    "kv_layout='paged' requires decode_mode='batched' — "
                    "the vmapped decode_step has no paged cache path")
            info = self.mod.paged_info(cfg, cache_len, page_size)
            self._paged = True
            self.pages_per_lane = int(info["pages_per_lane"])
            self._capacity = int(info["capacity"])
            self._alloc_mode = info["alloc"]           # incremental | full
            self.prefix_sharing = bool(info["prefix_sharing"]) and \
                prefix_sharing
            # auto pool: garbage page + a full complement per lane + one
            # lane's worth of slack for retained prefix entries
            self.num_pages = num_pages if num_pages is not None else \
                1 + (max_slots + 1) * self.pages_per_lane
            if self.num_pages < 1 + self.pages_per_lane:
                raise ValueError(
                    f"num_pages={self.num_pages} cannot hold even one "
                    f"lane ({self.pages_per_lane} pages + garbage page)")
            self.pool = PagePool(self.num_pages, page_size,
                                 metrics=self.metrics)
            # host mirrors of the device page table / lane positions:
            # allocation decisions need no device reads
            self._pt_host = np.zeros((max_slots, self.pages_per_lane),
                                     np.int32)
            self._host_pos = np.zeros(max_slots, np.int64)
        else:
            self.prefix_sharing = False
        self.kv_layout = "paged" if self._paged else "ring"
        # prefill row length: paged capacity rounds cache_len up to whole
        # pages, and the splice reads the first n*ps ring slots
        self._prefill_len = self._capacity if self._paged else cache_len
        # the registry backend name; resolving it raises on a name the
        # registry does not know (OpSpec.backend would fall back to 'ref')
        if attn_backend is not None:
            from repro_torch.core.ops import resolve_decode_backend
            try:
                resolve_decode_backend(attn_backend,
                                       quantized=(kv_dtype == "int8"),
                                       paged=self._paged, device=self.device)
            except ValueError as e:
                raise ValueError(f"unknown attn_backend {attn_backend!r}: "
                                 f"{e}") from None
        self.attn_backend = attn_backend
        self._prefill_backend = cm.flash_backend_of(attn_backend)
        self.pending: Deque[Request] = deque()
        self.slots: List[Optional[Request]] = [None] * max_slots
        self._steps_left = np.zeros(max_slots, np.int64)
        # -- request-lifecycle state ------------------------------------
        self.eos_id = eos_id
        if max_stop_tokens < 1:
            raise ValueError("max_stop_tokens must be >= 1")
        self.max_stop_tokens = max_stop_tokens
        self.eos_check_interval = max(1, eos_check_interval)
        self.watchdog_ticks = watchdog_ticks
        self.faults = faults
        if faults is not None and telemetry is not None \
                and getattr(faults, "telemetry", None) is None:
            faults.telemetry = telemetry       # injected faults leave traces
        self._tick_no = 0
        self._stall_ticks = 0
        # uids cancelled before we could find them — consumed at admission
        self._cancel_requested: set = set()
        # host mirror of which lanes have a non-empty stop set: the
        # periodic done-mask fetch runs only when a live lane could stop
        self._has_stops = np.zeros(max_slots, bool)
        self._stop_sets: List[frozenset] = [frozenset()] * max_slots
        self.slo_ttft_s = slo_ttft_s
        self.slo_itl_s = slo_itl_s
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(seed)
        self._rows = torch.arange(max_slots, device=self.device)
        # the decode step's sampling noise, drawn before each step and
        # outside a captured graph, so the generator advances as it does
        # in the eager step
        self._noise = torch.empty((max_slots, cfg.vocab_size),
                                  dtype=torch.float32, device=self.device)
        # the batched step of a capturable family on a CUDA device is
        # captured at its first call and replayed after it; every input
        # it reads is a tensor below, written in place, never rebound
        self._graphable = (self.device.type == "cuda"
                           and self.decode_mode == "batched"
                           and getattr(self.mod, "CUDA_GRAPH_SAFE", False))
        self._graph = None
        # the other captured programs (admission per bucket, the suffix
        # step, its closing sample) share one memory pool; nothing they
        # return lives in it
        self._graphs: Dict[Any, Captured] = {}
        self._pool = None
        self.state = self._init_state()
        # the admission's first-token noise (drawn before the program, as
        # the step's) and the suffix step's logits of its lane
        self._first_noise = torch.empty((1, cfg.vocab_size),
                                        dtype=torch.float32,
                                        device=self.device)
        self._suffix_logits = torch.empty((cfg.vocab_size,),
                                          dtype=torch.float32,
                                          device=self.device)
        self._init_inputs(max(self._prefill_len,
                              max(self.prefill_buckets or [0])))
        # the one device->host transfer per retirement lands here
        self._pinned = torch.empty(
            max_new_cap + 2, dtype=torch.int32,
            pin_memory=self.device.type == "cuda")
        # roofline accountant: analytic bytes/flops per decode token from
        # cache/param METADATA and the host-mirrored lane positions
        self._host_valid = np.zeros(max_slots, np.int64)
        self.roofline = RooflineAccountant(
            cfg, self.state["cache"], params, batch=max_slots,
            paged=self._paged, page_size=page_size,
            pages_per_lane=getattr(self, "pages_per_lane", 0), hw=hw)
        # achieved-vs-roofline window anchor: (bytes, flops, tokens,
        # decode_s) at the last utilization record
        self._rf_anchor = (0.0, 0.0, 0, 0.0)

    # -- device-side state and programs -------------------------------------

    def _init_state(self) -> Dict[str, Any]:
        b, cap, dev = self.max_slots, self.max_new_cap, self.device
        cache_kw = {"kv_dtype": self.kv_dtype}
        if self._paged:
            cache_kw.update(page_size=self.page_size,
                            num_pages=self.num_pages)
        i32 = dict(dtype=torch.int32, device=dev)
        return {
            "tokens": torch.zeros((b, 1), **i32),
            "pos": torch.zeros((b,), **i32),
            "temp": torch.zeros((b,), dtype=torch.float32, device=dev),
            "active": torch.zeros((b,), dtype=torch.bool, device=dev),
            "budget": torch.zeros((b,), **i32),   # per-slot max_new_tokens
            "out_buf": torch.full((b, cap), self.pad_id, **i32),
            "out_len": torch.zeros((b,), **i32),
            # per-lane stop-token set, -1 = empty; a lane that samples
            # one of these clears its own active bit on the device
            "stop": torch.full((b, self.max_stop_tokens), -1, **i32),
            "cache": self.mod.init_cache(self.cfg, b, self.cache_len,
                                         torch.float32, device=dev,
                                         **cache_kw),
        }

    # the block of device inputs that admission, the suffix step and its
    # closing sample read: int32 fields at fixed offsets (temp's fp32
    # bits), then the pages row and the left-padded prompt
    _FIELDS = ("tok", "pos", "slot", "plen", "budget", "temp")

    def _init_inputs(self, prompt_room: int) -> None:
        at = {k: i for i, k in enumerate(self._FIELDS)}
        at["stop"] = len(self._FIELDS)
        at["pages"] = at["stop"] + self.max_stop_tokens
        at["toks"] = at["pages"] + (self.pages_per_lane if self._paged
                                    else 0)
        self._in_at = at
        self._in_host = np.zeros(at["toks"] + prompt_room, np.int32)
        self._in = torch.zeros(self._in_host.shape, dtype=torch.int32,
                               device=self.device)

    def _inputs(self) -> Dict[str, torch.Tensor]:
        """Views of the input block by field (no copies)."""
        at, blk = self._in_at, self._in
        views = {k: blk[at[k]:at[k] + 1] for k in self._FIELDS}
        views["temp"] = views["temp"].view(torch.float32)
        views["stop"] = blk[at["stop"]:at["pages"]]
        views["pages"] = blk[at["pages"]:at["toks"]]
        views["toks"] = blk[at["toks"]:]
        return views

    def _stage(self, lo: int, hi: int) -> None:
        """Copy ``[lo, hi)`` of the host mirror into the input block: one
        non-blocking copy on the current stream from pinned memory that
        the caching host allocator holds until the copy has run."""
        src = torch.from_numpy(self._in_host[lo:hi])
        if self.device.type == "cuda":
            src = src.pin_memory()
        self._in[lo:hi].copy_(src, non_blocking=True)

    def _stage_lane(self, slot: int, req: "Request", plen: int,
                    toks: Optional[np.ndarray] = None,
                    pages: Optional[List[int]] = None) -> None:
        """Stage an admission's inputs: the lane scalars and stop row, and
        with ``toks`` (the left-padded prompt) the prompt and its pages."""
        at, h = self._in_at, self._in_host
        h[at["slot"]], h[at["plen"]] = slot, plen
        h[at["budget"]] = req.max_new_tokens
        h[at["temp"]] = np.float32(req.temperature).view(np.int32)
        h[at["stop"]:at["pages"]] = self._stop_row(req)
        hi = at["pages"]
        if toks is not None:
            h[at["pages"]:at["toks"]] = 0
            if pages is not None:
                h[at["pages"]:at["pages"] + len(pages)] = pages
            h[at["toks"]:at["toks"] + plen] = toks
            hi = at["toks"] + plen
        self._stage(at["slot"], hi)

    def _run(self, key, program: Callable[[], None],
             captured: bool = True) -> None:
        """Run ``program``: on a CUDA device of a capturable family,
        unless ``captured`` is False or inside ``disable_graphs()``, as
        the CUDA graph kept under ``key`` (captured at its first call,
        in the scheduler's one pool); else eagerly."""
        if not (captured and self._graphable and graphs_enabled()):
            program()
            return
        graph = self._graphs.get(key)
        if graph is not None:
            graph.replay()
            return
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        self._graphs[key] = capture(program, self.device, pool=self._pool)[1]

    def _upload(self, array: np.ndarray) -> torch.Tensor:
        """Host array -> the device without a blocking copy: pinned
        staging and a non-blocking transfer on the current stream."""
        t = torch.from_numpy(np.ascontiguousarray(array))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _fetch_lane(self, slot: int) -> np.ndarray:
        """The lane's output row, its length and its active bit, in ONE
        device->host transfer through pinned memory (a host sync)."""
        st = self.state
        staged = torch.cat([st["out_buf"][slot], st["out_len"][slot:slot + 1],
                            st["active"][slot:slot + 1].to(torch.int32)])
        if self.device.type != "cuda":
            return staged.numpy().copy()
        host = self._pinned[:staged.numel()]
        host.copy_(staged, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))
        done.synchronize()
        return host.numpy().copy()

    def _decode_slots(self, tokens, cache, pos):
        """The family's B=1 decode_step looped over lanes, each on views of
        its cache row (written in place) at its own position."""
        out = []
        for b in range(self.max_slots):
            row = {k: c[:, b:b + 1] for k, c in cache.items()}
            lg, _ = self.mod.decode_step(self.cfg, self.params,
                                         tokens[b:b + 1], row, pos[b])
            out.append(lg.reshape(-1)[-self.cfg.vocab_size:])
        return torch.stack(out)

    def _decode_lanes(self, tokens, pos):
        """One decode step for every lane (cache written in place): the
        lane-major batched path (default) or the looped B=1 reference."""
        cache = self.state["cache"]
        if self.decode_mode == "batched":
            lg, _ = self.mod.decode_step_batch(
                self.cfg, self.params, tokens, cache, pos,
                attn_backend=self.attn_backend)
            return lg.reshape(self.max_slots, -1, self.cfg.vocab_size)[:, -1]
        return self._decode_slots(tokens, cache, pos)

    def _step(self) -> None:
        """Advance every lane one token.  A capturable family's batched
        step on a CUDA device runs as one CUDA graph, captured at the
        scheduler's first step (a real step, run on the capture stream
        first) and replayed at every later one, as the JAX package jits
        ``_step``; under ``disable_graphs()``, or elsewhere, it runs
        eagerly.  Both run :meth:`_advance` on the same tensors."""
        self.decode_steps += 1
        self._noise.uniform_(generator=self._generator)
        if not (self._graphable and graphs_enabled()):
            self._advance()
        elif self._graph is None:
            _, self._graph = capture(self._advance, self.device)
        else:
            self._graph.replay()

    def _advance(self) -> None:
        """The step's device work, in place on ``self.state``: the decode
        step, sampling with ``self._noise``, the output scatter."""
        st = self.state
        last = self._decode_lanes(st["tokens"], st["pos"])
        nxt = _sample(self._generator, last, st["temp"], self._noise)
        write = st["active"] & (st["out_len"] < st["budget"])
        cols = st["out_len"].clamp(0, self.max_new_cap - 1).long()
        cur = st["out_buf"][self._rows, cols]
        st["out_buf"][self._rows, cols] = torch.where(write, nxt, cur)
        # device-side EOS: a lane whose sampled token is in its stop set
        # clears its own active bit; the stop token IS written to the
        # output.  -1 entries never match (tokens are >= 0).
        stop_hit = write & (nxt[:, None] == st["stop"]).any(dim=-1)
        st["tokens"].copy_(torch.where(write[:, None], nxt[:, None],
                                       st["tokens"]))
        st["pos"].add_(write.to(torch.int32))
        st["active"].copy_(write & ~stop_hit)
        st["out_len"].add_(write.to(torch.int32))

    def _deactivate(self, slot: int) -> None:
        """Clear one lane's active bit (cancel/timeout retirement) so its
        later masked writes stay masked."""
        self.state["active"][slot].fill_(False)

    def _set_lane(self, first) -> None:
        """Splice the lane scalars of an admission from the input block:
        ``first`` is the sampled first token (a 0-dim device tensor), the
        lane a device index, so one program serves every lane."""
        st, inp = self.state, self._inputs()
        lane = inp["slot"].long()
        hit = (first == inp["stop"]).any()
        row = torch.full((1, self.max_new_cap), self.pad_id,
                         dtype=torch.int32, device=self.device)
        row[0, 0] = first
        st["tokens"].index_copy_(0, lane, first.reshape(1, 1))
        st["pos"].index_copy_(0, lane, inp["plen"])
        st["temp"].index_copy_(0, lane, inp["temp"])
        st["active"].index_copy_(0, lane, (~hit).reshape(1))
        st["budget"].index_copy_(0, lane, inp["budget"])
        st["out_buf"].index_copy_(0, lane, row)
        st["out_len"].index_fill_(0, lane, 1)
        st["stop"].index_copy_(0, lane, inp["stop"][None])

    def _prefill_row(self, plen: int):
        """Prefill the block's prompt of ``plen`` tokens (B=1) in fp32,
        sample its first token on the device with ``_first_noise``, and
        convert the row to the live cache dtype."""
        inp = self._inputs()
        logits, cache1 = self.mod.prefill(self.cfg, self.params,
                                          inp["toks"][:plen].view(1, plen),
                                          self._prefill_len,
                                          cache_dtype=torch.float32,
                                          backend=self._prefill_backend)
        # quantize/cast AFTER the float prefill, once per admission
        cache1 = self.mod.cache_to_kv_dtype(self.cfg, cache1, self.kv_dtype)
        first = _sample(self._generator, logits[:, -1], inp["temp"],
                        self._first_noise)[0]
        return first, cache1

    def _admission_program(self, plen: int) -> Callable[[], None]:
        """The admission of one padded prompt length, JAX's ``_admit`` /
        ``_admit_paged`` with static ``plen``: prefill, the splice of the
        row into the lane (ring; or its first pages, a fixed count per
        ``plen``, into the pool) and the lane scalars.  Every other input
        is read from the block, so the same program serves every request
        of that length."""
        npages = 0
        if self._paged:
            npages = self.pages_per_lane if self._alloc_mode == "full" \
                else -(-plen // self.page_size)

        def admit() -> None:
            first, row = self._prefill_row(plen)
            inp = self._inputs()
            lane = inp["slot"].long()
            cache = self.state["cache"]
            if self._paged:
                self.mod.cache_splice_paged(self.cfg, cache, row, lane,
                                            inp["pages"][:npages],
                                            self.page_size)
            else:
                for key, c in cache.items():
                    cm.splice_lane(c, row[key], lane)
            self._set_lane(first)
        return admit

    def _admit(self, toks: np.ndarray, slot: int, req: "Request",
               pages: Optional[List[int]] = None) -> None:
        """Cold admission of the left-padded prompt ``toks`` (1, plen)
        into lane ``slot`` (paged: onto the fresh ``pages``): stage the
        inputs, draw the first token's noise, run the admission program
        of this length, captured per prefill bucket (a length past the
        top bucket, or without buckets, runs eagerly)."""
        plen = toks.shape[1]
        block = (self._in, self._in_host)
        if self._in_at["toks"] + plen > self._in.numel():
            # past the block's room, so past the top bucket and never
            # captured: this admission reads a block of its own, and the
            # captured programs keep theirs
            self._init_inputs(plen)
        try:
            self._stage_lane(slot, req, plen, toks=toks[0], pages=pages)
            self._first_noise.uniform_(generator=self._generator)
            self._run(("admit", plen), self._admission_program(plen),
                      captured=plen in (self.prefill_buckets or ()))
        finally:
            self._in, self._in_host = block

    def _suffix_program(self) -> None:
        """One suffix-prefill step for a prefix-cache hit: the block's
        ``tok`` at ``pos`` on lane ``slot`` through the regular batched
        decode (writing its KV through the page table), the lane's
        logits into ``_suffix_logits``.  The other lanes' writes are
        idempotent (each recomputes the KV of its current token at its
        current position), and only the cache advances."""
        st, inp = self.state, self._inputs()
        lane = inp["slot"].long()
        tokens = st["tokens"].index_copy(0, lane, inp["tok"][None])
        pos = st["pos"].index_copy(0, lane, inp["pos"])
        logits = self._decode_lanes(tokens, pos)
        self._suffix_logits.copy_(logits.index_select(0, lane)[0])

    def _stage_suffix(self, tok: int, slot: int, pos: int) -> None:
        at, h = self._in_at, self._in_host
        h[at["tok"]], h[at["pos"]], h[at["slot"]] = tok, pos, slot
        self._stage(at["tok"], at["slot"] + 1)

    def _suffix_step(self, tok: int, slot: int, pos: int) -> None:
        """Stage ``tok``, ``pos`` and ``slot`` and run the suffix step
        (one CUDA graph per scheduler on a card)."""
        self.decode_steps += 1
        self._stage_suffix(tok, slot, pos)
        self._run("suffix", self._suffix_program)

    def _finalize_program(self) -> None:
        """Close a prefix-hit admission: sample the first output token
        from the last suffix step's logits, splice the lane scalars."""
        first = _sample(self._generator, self._suffix_logits[None],
                        self._inputs()["temp"], self._first_noise)[0]
        self._set_lane(first)

    def _finalize_admit(self, slot: int, req: "Request", plen: int) -> None:
        self._stage_lane(slot, req, plen)
        self._first_noise.uniform_(generator=self._generator)
        self._run("finalize", self._finalize_program)

    def _set_pt_row(self, slot: int, row: Optional[np.ndarray]) -> None:
        table = self.state["cache"]["page_table"]
        if row is None:
            table[slot].fill_(0)
        else:
            table[slot] = self._upload(row)

    def _set_pt_entry(self, slot: int, idx: int, pid: int) -> None:
        self.state["cache"]["page_table"][slot, idx].fill_(pid)

    def _copy_page(self, src: int, dst: int, slot: int, idx: int) -> None:
        """Copy-on-write: duplicate pool page ``src`` into ``dst`` across
        every pool leaf and repoint the lane's table entry."""
        cache = self.state["cache"]
        for k, c in cache.items():
            if k.endswith("_pages"):
                c[:, dst] = c[:, src]
        cache["page_table"][slot, idx].fill_(dst)

    # -- telemetry plumbing --------------------------------------------------
    # Every hook below is host-only (time.perf_counter + dict appends):
    # telemetry can never add a device->host transfer, so the
    # zero-host-syncs-per-token invariant holds with tracing on.  What
    # each timestamp MEANS under async dispatch is documented in
    # runtime/telemetry.py and docs/serving.md — in short, span ends
    # measure dispatch, and the per-token latency histograms are
    # anchored at the real sync points (retirement fetch, done-mask
    # fetch).

    def _span(self, name: str, **args):
        """Tracer span (no-op context when telemetry is off)."""
        if self.telemetry is None:
            return nullcontext()
        return self.telemetry.tracer.span(name, args=args or None)

    def _rt(self, uid: int):
        """The request's trace row, or None when telemetry is off."""
        return self.telemetry.request(uid) if self.telemetry is not None \
            else None

    def _record_admit(self, req: Request, slot: int, plen: int,
                      t_pop: float) -> None:
        """Queue-time + TTFT bookkeeping once a request holds a lane.
        TTFT is submit -> admission-dispatch-return (the first token is
        sampled inside the dispatched prefill program); recorded only on
        the FIRST admission so preempt/re-admit cycles don't re-count."""
        now = time.perf_counter()
        queue_s = t_pop - req.submitted_at
        self._host_valid[slot] = plen     # roofline: tokens in cache
        self.metrics.histogram("req.queue_s").record(queue_s)
        rt = self._rt(req.uid)
        if rt is not None:
            rt.admitted(slot, plen, queue_s)
        if req.first_token_at == 0.0:
            req.first_token_at = now
            ttft = now - req.submitted_at
            self.metrics.histogram("req.ttft_s").record(ttft)
            if rt is not None:
                rt.first_token(ttft)

    def _record_finish(self, req: Request) -> None:
        """End-to-end + amortized inter-token latency at the retirement
        fetch — the one real sync point, so the ITL number is anchored
        to device completion at the far end.  One observation per
        inter-token gap (requests weight the histogram by length)."""
        self.metrics.counter(
            "sched.finish." + (req.finish_reason or "unknown")).inc()
        self.metrics.histogram("req.e2e_s").record(
            req.finished_at - req.submitted_at)
        ntot = len(req.output)
        if ntot > 1 and req.first_token_at > 0.0:
            self.metrics.histogram("req.itl_s").record(
                (req.finished_at - req.first_token_at) / (ntot - 1),
                ntot - 1)
        self._record_slo(req, ntot)
        rt = self._rt(req.uid)
        if rt is not None:
            rt.finished(req.finish_reason or "unknown", ntot)

    def _slo_budgets(self, req: Request) -> tuple:
        """Effective (ttft, itl) budgets: per-request overrides, else the
        scheduler defaults; None disables that leg."""
        ttft = req.slo_ttft_s if req.slo_ttft_s is not None \
            else self.slo_ttft_s
        itl = req.slo_itl_s if req.slo_itl_s is not None else self.slo_itl_s
        return ttft, itl

    def _record_slo(self, req: Request, ntot: int) -> None:
        """Judge SLO attainment at finish and fold it into the goodput
        fraction.  Rules: requests with neither budget stay out of the
        denominator entirely; user cancellations are excluded too (the
        caller withdrew — neither met nor missed); a deadline timeout
        counts as missed regardless of its latencies (the request did
        not complete).  TTFT/ITL use the same dispatch/retirement
        anchors as the ``req.*`` histograms."""
        if req.finish_reason == "cancelled":
            return
        ttft_budget, itl_budget = self._slo_budgets(req)
        if ttft_budget is None and itl_budget is None:
            return
        self.metrics.counter("slo.requests").inc()
        ttft = (req.first_token_at - req.submitted_at) \
            if req.first_token_at > 0.0 else math.inf
        itl = ((req.finished_at - req.first_token_at) / (ntot - 1)) \
            if ntot > 1 and req.first_token_at > 0.0 else 0.0
        met = req.finish_reason != "timeout"
        if ttft_budget is not None and ttft > ttft_budget:
            self.metrics.counter("slo.ttft_violations").inc()
            met = False
        if itl_budget is not None and itl > itl_budget:
            self.metrics.counter("slo.itl_violations").inc()
            met = False
        if met:
            self.metrics.counter("slo.met").inc()
        self.metrics.gauge("slo.goodput").set(
            self.metrics.counter("slo.met").value
            / self.metrics.counter("slo.requests").value)

    def telemetry_snapshot(self) -> Dict[str, Any]:
        """Cheap host-state snapshot for diagnostics: live-lane ages,
        free capacity, last-tick duration.  Attached to cancel/timeout
        retirements (``Request.diagnostics``) and to the no-progress
        watchdog error."""
        now = time.perf_counter()
        return {
            "tick": self._tick_no,
            "last_tick_ms": round(self._last_tick_s * 1e3, 3),
            "lane_ages_s": {r.uid: round(now - r.submitted_at, 3)
                            for r in self.slots if r is not None},
            "pending_uids": [r.uid for r in self.pending],
            "free_lanes": sum(r is None for r in self.slots),
            "free_pages": self.pool.available() if self._paged else None,
            "pool_occupancy_frac": (
                1.0 - self.pool.available() / self.num_pages
                if self._paged else None),
            "prefix_hit_ratio": (
                self.prefix_hits / self.admissions
                if self._paged and self.admissions else None),
        }

    # -- host-side page bookkeeping ------------------------------------------

    def _alloc_pages(self, n: int, *, site: str = "",
                     slot: Optional[int] = None) -> Optional[List[int]]:
        """Claim ``n`` pages, evicting LRU prefix-cache entries under
        pressure; None when the pool genuinely cannot supply them.  The
        fault injector is consulted FIRST so an injected failure models
        hard exhaustion (no eviction rescue) deterministically."""
        if self.faults is not None and self.faults.on_alloc(
                site, tick=self._tick_no, slot=slot, n=n):
            self.metrics.counter("faults.alloc_failures").inc()
            return None
        pages = self.pool.alloc(n)
        while pages is None and self.pool.evict_one():
            pages = self.pool.alloc(n)
        return pages

    def _ensure_writable(self, slot: int, pos: int, site: str = "") -> bool:
        """Guarantee lane ``slot`` exclusively owns the page its write at
        ``pos`` lands in: allocate on first touch, copy-on-write when the
        page is shared (prefix reuse keeps refcount > 1).  Invariant:
        every non-garbage entry in a lane's table row holds exactly one
        refcount on behalf of that lane.

        Returns False — WITHOUT raising — when the pool cannot supply
        the page even after LRU eviction; the caller preempts a lane to
        free pages and retries."""
        idx = (pos % self._capacity) // self.page_size
        phys = int(self._pt_host[slot, idx])
        if phys == GARBAGE_PAGE:
            got = self._alloc_pages(1, site=site + "first_touch", slot=slot)
            if got is None:
                return False
            self._pt_host[slot, idx] = got[0]
            self._set_pt_entry(slot, idx, got[0])
        elif self.pool.refcount[phys] > 1:
            got = self._alloc_pages(1, site=site + "cow", slot=slot)
            if got is None:
                return False
            self._pt_host[slot, idx] = got[0]
            self._copy_page(phys, got[0], slot, idx)
            self.pool.free(phys)               # drop the lane's shared ref
            self.cow_copies += 1
        return True

    def _prepare_writes(self, extra: Optional[int] = None) -> None:
        """Run the COW/allocation check for every lane about to write —
        all active lanes with steps left, plus ``extra`` (a lane mid
        suffix-prefill).  Called before every device step that writes
        KV; 'full' allocation mode owns all pages up-front so only
        incremental mode does work here.

        When a page cannot be supplied, the lowest-priority lane is
        preempted (releasing its pages) and the check retries — the
        writing lane itself is the last candidate, in which case it is
        preempted instead of written."""
        if self._alloc_mode != "incremental":
            return
        for slot in range(self.max_slots):
            if slot == extra:
                continue
            while self.slots[slot] is not None \
                    and self._steps_left[slot] > 0 \
                    and not self._ensure_writable(
                        slot, int(self._host_pos[slot])):
                victim = self._preempt_lowest(protect=extra)
                if victim is None or victim == slot:
                    break

    def _preempt_lowest(self, protect: Optional[int] = None
                        ) -> Optional[int]:
        """Preempt the lowest-priority live lane (latest submit wins the
        axe, uid as tie-break) excluding ``protect``; returns the slot
        preempted, or None when no candidate exists."""
        victim = None
        key = None
        for slot, req in enumerate(self.slots):
            if req is None or slot == protect:
                continue
            k = (req.submitted_at, req.uid, slot)
            if key is None or k > key:
                victim, key = slot, k
        if victim is not None:
            self._preempt(victim)
        return victim

    def _preempt(self, slot: int) -> None:
        """vLLM-style recompute preemption: snapshot the lane's produced
        tokens, fold them into the prompt, release every page, and
        requeue at the FRONT of pending — re-admission recomputes the
        whole (prompt + produced) prefix through the normal
        prefill/prefix-cache path, so greedy output is token-identical
        to an uninterrupted run."""
        req = self.slots[slot]
        if int(self._steps_left[slot]) <= 0:
            # nothing left to decode — this is a retirement, not a preempt
            self._retire_slot(slot, "length")
            return
        fetched = self._fetch_lane(slot)
        self.host_syncs += 1
        row, n, alive = fetched[:-2], int(fetched[-2]), bool(fetched[-1])
        if not alive:
            # the lane already hit EOS on device; retire it instead of
            # recomputing a finished sequence
            self._retire_slot(slot, "eos", _prefetched=(row, n))
            return
        produced = [int(t) for t in row[:n]]
        req.output.extend(produced)
        self.tokens_generated += n
        req.prompt = list(req.prompt) + produced
        req.max_new_tokens -= n
        self.slots[slot] = None
        self._steps_left[slot] = 0
        self._host_valid[slot] = 0
        self._set_stop_host(slot, None)
        self._deactivate(slot)
        if self._paged:
            self._release_lane_pages(slot)
        self.pending.appendleft(req)
        self.preemptions += 1
        rt = self._rt(req.uid)
        if rt is not None:
            rt.preempted(n)

    def _release_lane_pages(self, slot: int) -> None:
        """Drop the lane's reference on every page in its table row and
        zero the row on host AND device — a retired lane's stale mapping
        must never alias a reallocated page."""
        for idx in range(self.pages_per_lane):
            phys = int(self._pt_host[slot, idx])
            if phys != GARBAGE_PAGE:
                self.pool.free(phys)
        self._pt_host[slot] = 0
        self._host_pos[slot] = 0
        self._set_pt_row(slot, None)

    # -- host-side scheduling ------------------------------------------------

    def submit(self, request: Request) -> None:
        request.submitted_at = time.perf_counter()
        if request.max_new_tokens > self.max_new_cap:
            raise ValueError(
                f"request {request.uid}: max_new_tokens="
                f"{request.max_new_tokens} exceeds scheduler cap "
                f"{self.max_new_cap}")
        if len(self._stop_set(request)) > self.max_stop_tokens:
            raise ValueError(
                f"request {request.uid}: {len(self._stop_set(request))} "
                f"stop tokens exceed max_stop_tokens="
                f"{self.max_stop_tokens}")
        plen = self._bucket(len(request.prompt))
        # the last decode step writes KV at position plen + max_new - 2
        # (the final sampled token is never fed back), so any request
        # with plen + max_new_tokens - 1 > window would wrap the cache
        # mid-decode and corrupt its own prefix.  Families whose window
        # wraps by design (rglru's local attention) or that have no KV
        # ring at all (rwkv6) set RING_WRAP_SAFE and skip the guard.
        # Their prefill also takes a prompt longer than the ring (rglru
        # keeps its last window of keys, rolled into place; rwkv6 has no
        # ring), so the prompt-length guards below do not apply to them
        # either: the JAX package keeps those, and refuses such prompts.
        wrap_safe = getattr(self.mod, "RING_WRAP_SAFE", False)
        if self._paged:
            # pool-capacity guard (the old cache_len bound is obsolete:
            # a lane's logical window wraps at pages_per_lane * page_size
            # like the ring did, but pages must EXIST in the pool)
            if not wrap_safe and plen > self._capacity:
                raise ValueError(
                    f"request {request.uid}: prompt length "
                    f"{len(request.prompt)} (padded to {plen}) exceeds "
                    f"the paged lane capacity {self._capacity} "
                    f"({self.pages_per_lane} pages x {self.page_size})")
            if not wrap_safe and \
                    plen + request.max_new_tokens - 1 > self._capacity:
                raise ValueError(
                    f"request {request.uid}: prompt ({plen} padded) + "
                    f"max_new_tokens ({request.max_new_tokens}) would "
                    f"wrap the paged window ({self._capacity}) mid-decode "
                    "and corrupt the prompt prefix; shrink one of them")
            need = min(-(-(plen + request.max_new_tokens)
                         // self.page_size), self.pages_per_lane)
            if need > self.num_pages - 1:
                raise ValueError(
                    f"request {request.uid}: needs {need} pages but the "
                    f"pool holds only {self.num_pages - 1} allocatable "
                    f"(num_pages={self.num_pages} incl. garbage page)")
        elif not wrap_safe and plen > self.cache_len:
            raise ValueError(
                f"request {request.uid}: prompt length "
                f"{len(request.prompt)} (padded to {plen} by the prefill "
                f"bucket) exceeds cache_len={self.cache_len} — the ring "
                f"cache would wrap during prefill and corrupt the prefix")
        elif not wrap_safe and \
                plen + request.max_new_tokens - 1 > self.cache_len:
            raise ValueError(
                f"request {request.uid}: prompt ({plen} padded) + "
                f"max_new_tokens ({request.max_new_tokens}) would wrap "
                f"the ring cache (cache_len={self.cache_len}) mid-decode "
                "and corrupt the prompt prefix; shrink one of them")
        rt = self._rt(request.uid)
        if rt is not None:
            rt.submitted(len(request.prompt), request.max_new_tokens)
        self.pending.append(request)

    def _stop_set(self, req: Request) -> frozenset:
        stops = set(req.stop_tokens or ())
        if self.eos_id is not None:
            stops.add(self.eos_id)
        return frozenset(stops)

    def _stop_row(self, req: Request) -> np.ndarray:
        row = np.full((self.max_stop_tokens,), -1, np.int32)
        stops = sorted(self._stop_set(req))
        row[:len(stops)] = stops
        return row

    def _set_stop_host(self, slot: int, req: Optional[Request]) -> None:
        """Mirror a lane's stop set on the host so the periodic done-mask
        fetch can be skipped entirely when no live lane could stop."""
        stops = self._stop_set(req) if req is not None else frozenset()
        self._stop_sets[slot] = stops
        self._has_stops[slot] = bool(stops)

    def _bucket(self, plen: int) -> int:
        if self.prefill_buckets is None:
            return plen
        for b in self.prefill_buckets:
            if plen <= b:
                return b
        return plen

    def _admit_pending(self) -> bool:
        t0 = time.perf_counter()
        admitted = False
        defer = False
        for slot in range(self.max_slots):
            if defer:
                break
            while not defer and self.pending \
                    and self.slots[slot] is None:
                req = self.pending.popleft()
                t_pop = time.perf_counter()
                # drop requests cancelled or expired while queued —
                # before any device work or page refs
                if req.uid in self._cancel_requested:
                    self._cancel_requested.discard(req.uid)
                    self._finish_dropped(req, "cancelled")
                    continue
                if self._deadline_expired(req):
                    self._finish_dropped(req, "timeout")
                    continue
                if self.faults is not None:
                    self.faults.on_admission(req, tick=self._tick_no,
                                             scheduler=self)
                    if req.uid in self._cancel_requested:
                        self._cancel_requested.discard(req.uid)
                        self._finish_dropped(req, "cancelled")
                        continue
                plen = self._bucket(len(req.prompt))
                toks = np.full((1, plen), self.pad_id, np.int32)
                toks[0, plen - len(req.prompt):] = req.prompt  # left-pad
                with self._span("admit", uid=req.uid, slot=slot,
                                plen=plen):
                    if self._paged:
                        verdict = self._admit_paged_host(req, slot, toks,
                                                         plen)
                    else:
                        verdict = "ok"
                        self._admit(toks, slot, req)
                if verdict == "dropped":
                    continue                   # cancelled mid-admission
                if verdict == "defer":
                    # pool pressure: requeue and stop admitting —
                    # running lanes retire and release pages
                    if self.telemetry is not None:
                        self.telemetry.tracer.instant(
                            "admit_defer", args={"uid": req.uid})
                    self.pending.appendleft(req)
                    defer = True
                    break
                self.slots[slot] = req
                self._set_stop_host(slot, req)
                # the sampled-at-prefill first token is output token #1
                self._steps_left[slot] = req.max_new_tokens - 1
                self._record_admit(req, slot, plen, t_pop)
                admitted = True
                break
        if admitted:
            self.prefill_s += time.perf_counter() - t0
        return admitted

    def _admit_paged_host(self, req: Request, slot: int, toks: np.ndarray,
                          plen: int) -> str:
        """Paged admission: prefix-cache lookup first (map shared pages
        read-only and prefill only the suffix), else allocate pages and
        run the full prefill + splice.

        Returns ``"ok"``, ``"defer"`` (pool cannot supply the pages even
        after LRU eviction and preemption — requeue), or ``"dropped"``
        (cancelled mid-admission — request finished, do not requeue).
        Both failure paths fully unwind: every ref this admission took
        is released and the counters roll back, so an aborted prefix-hit
        leaks nothing."""
        ps = self.page_size
        npages = self.pages_per_lane if self._alloc_mode == "full" \
            else -(-plen // ps)
        key_tokens = [int(t) for t in toks[0]]
        self.admissions += 1
        self.prefill_tokens_total += plen
        entry = self.pool.prefix_lookup(key_tokens) \
            if self.prefix_sharing else None
        if entry is not None:
            # cap the reused length at plen - 1 so at least one suffix
            # step runs — its logits seed the first sampled token
            t = min(entry.length, plen - 1)
            span = -(-t // ps)
            shared = list(entry.pages[:span])
            self.prefix_hits += 1
            self.prefill_tokens_saved += t
            rt = self._rt(req.uid)
            if rt is not None:
                rt.prefix_lookup(True, t)
            for p in shared:
                self.pool.ref(p)
            self._pt_host[slot] = 0
            self._pt_host[slot, :span] = shared
            row = np.zeros((self.pages_per_lane,), np.int32)
            row[:span] = shared
            self._set_pt_row(slot, row)
            # suffix prefill: one batched step per remaining prompt token
            aborted = None
            with self._span("suffix_prefill", uid=req.uid,
                            tokens=plen - t):
                for i in range(t, plen):
                    if self.faults is not None:
                        self.faults.on_suffix_step(req, slot, i,
                                                   tick=self._tick_no,
                                                   scheduler=self)
                    if req.uid in self._cancel_requested:
                        self._cancel_requested.discard(req.uid)
                        aborted = "dropped"
                        break
                    self._prepare_writes(extra=slot)
                    while not self._ensure_writable(slot, i,
                                                    site="suffix:"):
                        if self._preempt_lowest(protect=slot) is None:
                            aborted = "defer"
                            break
                    if aborted:
                        break
                    self._suffix_step(int(toks[0, i]), slot, i)
            if aborted:
                # unwind: drop every ref this lane holds (shared pages
                # it mapped AND pages the suffix loop allocated/COW'd)
                # and roll the admission counters back
                self._release_lane_pages(slot)
                self.admissions -= 1
                self.prefix_hits -= 1
                self.prefill_tokens_total -= plen
                self.prefill_tokens_saved -= t
                if aborted == "dropped":
                    self._finish_dropped(req, "cancelled")
                return aborted
            self._finalize_admit(slot, req, plen)
        else:
            rt = self._rt(req.uid)
            if rt is not None:
                rt.prefix_lookup(False, 0)
            pages = self._alloc_pages(npages, site="admission", slot=slot)
            if pages is None:
                self.admissions -= 1
                self.prefill_tokens_total -= plen
                return "defer"
            self._pt_host[slot] = 0
            self._pt_host[slot, :npages] = pages
            self._admit(toks, slot, req, pages)
        self._host_pos[slot] = plen
        if self.prefix_sharing:
            # publish this lane's page-aligned prefixes (and the full
            # prompt).  COW keeps the entries pristine once the lane
            # decodes past them.
            span_full = -(-plen // ps)
            self.pool.prefix_register(
                key_tokens,
                [int(p) for p in self._pt_host[slot, :span_full]])
        return "ok"

    def _retire_slot(self, slot: int, reason: str,
                     _prefetched=None) -> None:
        """Finish the request on ``slot``: fetch its produced tokens in
        ONE device->host transfer, record its finish reason, free its
        lane (and pages), and tally the lifecycle counters."""
        req = self.slots[slot]
        if _prefetched is not None:
            row, n = _prefetched
        else:
            # the fetch is where async dispatch settles — this span's
            # duration is real device catch-up time, not dispatch cost
            with self._span("retire_fetch", uid=req.uid, slot=slot):
                fetched = self._fetch_lane(slot)
            self.host_syncs += 1
            row, n = fetched[:-2], fetched[-2]
        n = int(n)
        produced = [int(t) for t in row[:n]]
        req.output.extend(produced)
        self.tokens_generated += n
        if reason == "length" and produced \
                and produced[-1] in self._stop_sets[slot]:
            # the lane sampled EOS on its final budgeted step (or the
            # periodic mask check hadn't run yet) — the budget is spent
            # but the sequence still terminated properly
            reason = "eos"
        if reason == "eos":
            self.eos_finishes += 1
            self.eos_steps_saved += max(req.max_new_tokens - n, 0)
        elif reason == "cancelled":
            self.cancellations += 1
        elif reason == "timeout":
            self.deadline_misses += 1
        if reason in ("cancelled", "timeout"):
            # the lane may still be active on device: mask it out so its
            # writes stop before the slot is reused
            self._deactivate(slot)
        req.finish_reason = reason
        req.done = True
        req.finished_at = time.perf_counter()
        if reason in ("cancelled", "timeout"):
            # attach the why-did-this-die snapshot before the lane state
            # is torn down (satellite: "stuck" becomes a diagnosis)
            req.diagnostics = self.telemetry_snapshot()
        self._record_finish(req)
        self.slots[slot] = None
        self._steps_left[slot] = 0
        self._host_valid[slot] = 0
        self._set_stop_host(slot, None)
        if self._paged:
            self._release_lane_pages(slot)

    def _retire_finished(self) -> None:
        for slot, req in enumerate(self.slots):
            if req is None or self._steps_left[slot] > 0:
                continue
            self._retire_slot(slot, "length")

    def _finish_dropped(self, req: Request, reason: str) -> None:
        """Finish a request that never reached a lane (cancelled or
        expired while pending) — no device state to unwind."""
        req.finish_reason = reason
        req.done = True
        req.finished_at = time.perf_counter()
        req.diagnostics = self.telemetry_snapshot()
        self._record_finish(req)
        if reason == "cancelled":
            self.cancellations += 1
        elif reason == "timeout":
            self.deadline_misses += 1

    def cancel(self, uid: int) -> bool:
        """Cancel a request by uid.  A pending request is dropped before
        it ever touches the device; a live lane is retired immediately
        (releasing its pages).  Unknown uids are remembered and consumed
        if the request shows up later (e.g. cancel raced an admission).
        Returns True when the request was found and finished now."""
        for r in self.pending:
            if r.uid == uid:
                # identity-based removal: Request is a dataclass with
                # field equality, and two requests can be field-equal
                self.pending = deque(x for x in self.pending if x is not r)
                self._finish_dropped(r, "cancelled")
                return True
        for slot, req in enumerate(self.slots):
            if req is not None and req.uid == uid:
                self._retire_slot(slot, "cancelled")
                return True
        self._cancel_requested.add(uid)
        return False

    def _deadline_expired(self, req: Request) -> bool:
        return req.deadline_s is not None and \
            time.perf_counter() - req.submitted_at > req.deadline_s

    def _expire_deadlines(self) -> None:
        for slot, req in enumerate(self.slots):
            if req is not None and self._deadline_expired(req):
                self._retire_slot(slot, "timeout")
        expired = [r for r in self.pending if self._deadline_expired(r)]
        if expired:
            self.pending = deque(x for x in self.pending
                                 if not any(x is r for r in expired))
            for r in expired:
                self._finish_dropped(r, "timeout")

    def _reconcile_eos(self) -> None:
        """Periodic done-mask fetch: retire lanes whose device-side stop
        check already cleared their active bit.  Skipped entirely unless
        some live mid-decode lane has a non-empty stop set, so stop-free
        workloads keep strict zero host syncs per token; when it runs it
        is ONE small (B,) bool transfer per ``eos_check_interval`` ticks,
        counted in ``mask_syncs``."""
        if not any(self._has_stops[s] and self.slots[s] is not None
                   and self._steps_left[s] > 0
                   for s in range(self.max_slots)):
            return
        alive = self.state["active"].cpu().numpy()
        self.mask_syncs += 1
        if self.telemetry is not None:
            # this fetch is a real sync point — mark it so trace readers
            # know where device completion is anchored
            self.telemetry.tracer.instant(
                "eos_mask_fetch", args={"tick": self._tick_no})
        for slot, req in enumerate(self.slots):
            if req is not None and self._steps_left[slot] > 0 \
                    and self._has_stops[slot] and not alive[slot]:
                self._retire_slot(slot, "eos")

    def tick(self) -> bool:
        """Admit pending requests, advance every active lane one token,
        retire finished requests.  Returns False once fully idle.

        ``decode_s`` covers step dispatch AND retirement fetches — the
        fetch is where the asynchronous launches settle, so excluding it
        would credit the scheduler with near-zero decode time."""
        self._tick_no += 1
        t_tick0 = time.perf_counter()
        tr = self.telemetry.tracer if self.telemetry is not None else None
        tick_ts0 = tr.now_us() if tr is not None else 0.0
        # progress snapshot for the no-progress watchdog
        marker = (self.host_syncs, self.preemptions, self.cancellations,
                  self.deadline_misses, len(self.pending))
        if self.faults is not None:
            self.faults.on_step(self._tick_no, self)
        self._expire_deadlines()
        admitted = self._admit_pending()
        t0 = time.perf_counter()
        worked = False
        if any(self._steps_left[s] > 0 for s, r in enumerate(self.slots)
               if r is not None):
            if self._paged:
                # every writing lane must own its target page before the
                # step lands (first-touch allocation / copy-on-write) —
                # this can preempt lanes, so re-check below
                with self._span("prepare_writes"):
                    self._prepare_writes()
        work = [s for s, r in enumerate(self.slots)
                if r is not None and self._steps_left[s] > 0]
        if work:
            # span/histogram measure ENQUEUE cost: the step's kernels are
            # launched asynchronously, the device may still be running
            with self._span("step_dispatch"):
                ts0 = time.perf_counter()
                self._step()
                self.metrics.histogram("sched.step_dispatch_s").record(
                    time.perf_counter() - ts0)
            # roofline accounting for the step just dispatched: host
            # arithmetic over the mirrored positions (pre-advance), no
            # device reads
            rf_bytes, rf_flops = self.roofline.step_cost(
                [int(self._host_valid[s]) for s in work])
            self.metrics.counter("roofline.analytic_bytes").inc(rf_bytes)
            self.metrics.counter("roofline.analytic_flops").inc(rf_flops)
            self.metrics.counter("roofline.tokens").inc(len(work))
            for slot in work:
                req = self.slots[slot]
                self._steps_left[slot] -= 1
                self._host_valid[slot] += 1
                if self._paged:
                    self._host_pos[slot] += 1
                rt = self._rt(req.uid)
                if rt is not None:
                    rt.progressed(req.max_new_tokens
                                  - int(self._steps_left[slot]))
            worked = True
        if worked and self._tick_no % self.eos_check_interval == 0:
            self._reconcile_eos()
        syncs = self.host_syncs
        self._retire_finished()
        retired = self.host_syncs > syncs
        if worked or retired:
            self.decode_s += time.perf_counter() - t0
        if retired:
            # the retirement fetch is where async dispatch settles —
            # amortize achieved-vs-roofline utilization against it so
            # MBU/MFU cost no extra sync
            self._record_utilization()
        busy = bool(self.pending) or any(r is not None for r in self.slots)
        progressed = admitted or worked or marker != (
            self.host_syncs, self.preemptions, self.cancellations,
            self.deadline_misses, len(self.pending))
        if busy and not progressed:
            self._stall_ticks += 1
            if self._stall_ticks >= self.watchdog_ticks:
                self._raise_stalled()
        else:
            self._stall_ticks = 0
        self._last_tick_s = time.perf_counter() - t_tick0
        if admitted or worked or retired:
            self.metrics.histogram("sched.tick_s").record(self._last_tick_s)
        self.metrics.gauge("sched.live_lanes").set(
            sum(r is not None for r in self.slots))
        if self._paged:
            self.metrics.gauge("pool.free_pages").set(self.pool.available())
            self.metrics.gauge("pool.occupancy_frac").set(
                1.0 - self.pool.available() / self.num_pages)
            if self.admissions:
                self.metrics.gauge("sched.prefix_hit_ratio").set(
                    self.prefix_hits / self.admissions)
        if tr is not None and (admitted or worked or retired):
            tr.complete("tick", tick_ts0, tr.now_us() - tick_ts0,
                        args={"tick": self._tick_no, "admitted": admitted,
                              "worked": worked, "retired": retired,
                              "pending": len(self.pending)})
            if self._paged:
                tr.counter_event("free_pages",
                                 {"free": self.pool.available()})
        return busy

    def _raise_stalled(self) -> None:
        lanes = [f"slot {s}: uid={r.uid} steps_left="
                 f"{int(self._steps_left[s])}"
                 + (f" pos={int(self._host_pos[s])}" if self._paged else "")
                 for s, r in enumerate(self.slots) if r is not None]
        snap = self.telemetry_snapshot()
        raise RuntimeError(
            f"scheduler made no progress for {self._stall_ticks} "
            f"consecutive ticks (tick {self._tick_no}): no admission, "
            f"no decode step, no retirement.  Live lanes: "
            f"{lanes or 'none'}; lane ages (s): {snap['lane_ages_s']}; "
            f"pending uids: {snap['pending_uids']}; free pages: "
            f"{snap['free_pages']}; last tick took "
            f"{snap['last_tick_ms']}ms.  "
            "This usually means host bookkeeping desynced from device "
            "state, or the pool cannot fit any pending request "
            f"(num_pages={getattr(self, 'num_pages', None)}).")

    def run(self) -> None:
        """Drive to idle: every submitted request generated and retired."""
        while self.tick():
            pass

    def free_slots(self) -> FreeCapacity:
        """Free admission capacity: open decode lanes, and (paged layout
        only) allocatable pages in the pool — ``pages`` is None for the
        ring layout, where lanes are the only resource."""
        lanes = sum(r is None for r in self.slots)
        pages = self.pool.available() if self._paged else None
        return FreeCapacity(lanes, pages)

    def kv_bytes_resident(self) -> int:
        """Device bytes actually holding KV state right now.  Ring: the
        full per-lane buffers (allocated whether or not a lane is live).
        Paged: only the referenced pages, plus the page-table and
        refcount bookkeeping arrays — the number the ISSUE's residency
        claim is measured on."""
        cache = self.state["cache"]
        if not self._paged:
            return sum(v.numel() * v.element_size() for v in cache.values())
        used = self.num_pages - self.pool.available()
        total = 0
        for k, v in cache.items():
            nbytes = v.numel() * v.element_size()
            if k.endswith("_pages"):
                total += (nbytes // self.num_pages) * used
            else:                   # page_table + dense per-lane leaves
                total += nbytes
        return total + self.pool.refcount.nbytes

    def paged_stats(self) -> Dict[str, Any]:
        """Prefix-cache / paging counters for benchmarks and tests."""
        return {
            "layout": self.kv_layout,
            "admissions": self.admissions,
            "prefix_hits": self.prefix_hits,
            "prefix_hit_rate": (self.prefix_hits / self.admissions
                                if self.admissions else 0.0),
            "prefill_tokens_total": self.prefill_tokens_total,
            "prefill_tokens_saved": self.prefill_tokens_saved,
            "prefill_tokens_saved_frac": (
                self.prefill_tokens_saved / self.prefill_tokens_total
                if self.prefill_tokens_total else 0.0),
            "cow_copies": self.cow_copies,
            "preemptions": self.preemptions,
            "lru_evictions": self.metrics.counter("pool.evictions").value,
            "kv_bytes_resident": self.kv_bytes_resident(),
            "free_pages": (self.pool.available() if self._paged else None),
            "prefix_entries": (self.pool.prefix_entries()
                               if self._paged else 0),
        }

    def lifecycle_stats(self) -> Dict[str, Any]:
        """Request-lifecycle counters: preemption recovery, device-side
        EOS savings, deadline misses, cancellations, and the done-mask
        fetch count the EOS mirror cost."""
        return {
            "preemptions": self.preemptions,
            "eos_finishes": self.eos_finishes,
            "eos_steps_saved": self.eos_steps_saved,
            "deadline_misses": self.deadline_misses,
            "cancellations": self.cancellations,
            "mask_syncs": self.mask_syncs,
            "finish_reasons": dict(self.finish_reasons),
            "stall_ticks": self._stall_ticks,
        }

    def _record_utilization(self) -> None:
        """Fold the accounted window since the last retirement into the
        MBU/MFU instruments.  ``decode_s``'s far edge is the retirement
        fetch that just completed, so 'achieved' is anchored to device
        completion; the anchor is re-based unconditionally so a
        registry ``reset()`` (bench warmup) self-heals next window."""
        by = self.metrics.counter("roofline.analytic_bytes").value
        fl = self.metrics.counter("roofline.analytic_flops").value
        tok = self.metrics.counter("roofline.tokens").value
        dt = self.decode_s - self._rf_anchor[3]
        d_by, d_fl = by - self._rf_anchor[0], fl - self._rf_anchor[1]
        d_tok = tok - self._rf_anchor[2]
        self._rf_anchor = (by, fl, tok, self.decode_s)
        if d_tok <= 0 or dt <= 0.0:
            return
        mbu, mfu = self.roofline.utilization(d_by, d_fl, dt)
        self.metrics.histogram("roofline.mbu").record(mbu)
        self.metrics.histogram("roofline.mfu").record(mfu)
        self.metrics.gauge("roofline.mbu_last").set(mbu)
        self.metrics.gauge("roofline.mfu_last").set(mfu)
        self.metrics.gauge("roofline.bytes_per_token").set(d_by / d_tok)
        self.metrics.gauge("roofline.flops_per_token").set(d_fl / d_tok)

    def roofline_stats(self) -> Dict[str, Any]:
        """Lifetime achieved-vs-roofline summary: analytic bytes/token
        and flops/token for the tokens actually decoded, the bandwidth
        ceiling they imply on this hardware, and the achieved MBU/MFU
        over accumulated decode (dispatch + retirement-fetch) time."""
        by = self.metrics.counter("roofline.analytic_bytes").value
        fl = self.metrics.counter("roofline.analytic_flops").value
        tok = self.metrics.counter("roofline.tokens").value
        dt = self.decode_s
        bpt = by / tok if tok else 0.0
        mbu, mfu = self.roofline.utilization(by, fl, dt)
        return {
            "hw": self.roofline.describe()["hw"],
            "tokens_accounted": tok,
            "analytic_bytes_total": by,
            "analytic_flops_total": fl,
            "bytes_per_token": bpt,
            "flops_per_token": fl / tok if tok else 0.0,
            "kv_read_bytes_per_token_max": self.roofline.kv_read_bytes(
                self._prefill_len),
            "roofline_tok_per_s": self.roofline.roofline_tok_per_s(bpt),
            "achieved_tok_per_s": tok / dt if dt > 0 else 0.0,
            "mbu": mbu,
            "mfu": mfu,
            "decode_s": dt,
        }

    def slo_stats(self) -> Dict[str, Any]:
        """SLO attainment counters and the goodput fraction (None until
        any budgeted request finishes)."""
        n = self.metrics.counter("slo.requests").value
        met = self.metrics.counter("slo.met").value
        return {
            "slo_ttft_s": self.slo_ttft_s,
            "slo_itl_s": self.slo_itl_s,
            "requests": n,
            "met": met,
            "ttft_violations": self.metrics.counter(
                "slo.ttft_violations").value,
            "itl_violations": self.metrics.counter(
                "slo.itl_violations").value,
            "goodput": met / n if n else None,
        }

    def audit_pages(self) -> None:
        """Assert the pool-refcount invariant: every page's refcount
        equals (1 for the garbage page) + (1 per live lane mapping it)
        + (1 per prefix-cache entry spanning it).  Raises AssertionError
        on any mismatch — the refcount-leak canary the fault-injection
        suite runs after every degraded path."""
        if not self._paged:
            return
        expected = np.zeros(self.num_pages, np.int64)
        expected[GARBAGE_PAGE] = 1
        for slot, req in enumerate(self.slots):
            if req is None:
                continue
            for phys in self._pt_host[slot]:
                if int(phys) != GARBAGE_PAGE:
                    expected[int(phys)] += 1
        expected += self.pool.entry_page_refs()
        actual = np.asarray(self.pool.refcount, np.int64)
        if not np.array_equal(expected, actual):
            bad = np.nonzero(expected != actual)[0]
            raise AssertionError(
                f"refcount leak: pages {bad.tolist()} expected "
                f"{expected[bad].tolist()} got {actual[bad].tolist()}")


# -- metric-backed attributes (the single stats surface) ---------------------
# The ad-hoc counters of PRs 1-8 (prefill_s/decode_s timers, paged and
# lifecycle tallies) now LIVE in the MetricsRegistry; the attribute names
# every test/bench/engine already uses are preserved as read-write
# properties over the registry cells, so `sched.preemptions += 1`,
# `sched.prefill_s = 0.0` (bench warmup resets) and
# `metrics.snapshot()["sched.preemptions"]` all see one number.

_METRIC_ATTRS = {
    "host_syncs": "sched.host_syncs",
    "tokens_generated": "sched.tokens_generated",
    "prefill_s": "sched.prefill_s",
    "decode_s": "sched.decode_s",
    "admissions": "sched.admissions",
    "prefix_hits": "sched.prefix_hits",
    "prefill_tokens_total": "sched.prefill_tokens_total",
    "prefill_tokens_saved": "sched.prefill_tokens_saved",
    "cow_copies": "sched.cow_copies",
    "preemptions": "sched.preemptions",
    "eos_finishes": "sched.eos_finishes",
    "eos_steps_saved": "sched.eos_steps_saved",
    "deadline_misses": "sched.deadline_misses",
    "cancellations": "sched.cancellations",
    "mask_syncs": "sched.mask_syncs",
    # batched decode steps dispatched, suffix-prefill steps included (the
    # port's own counter: each step launches one decode-attention kernel
    # per layer)
    "decode_steps": "sched.decode_steps",
}


def _metric_attr(metric: str) -> property:
    def fget(self):
        return self.metrics.counter(metric).value

    def fset(self, v):
        self.metrics.counter(metric).value = v

    return property(fget, fset, doc=f"registry counter {metric!r}")


for _attr, _metric in _METRIC_ATTRS.items():
    setattr(ContinuousBatchingScheduler, _attr, _metric_attr(_metric))

ContinuousBatchingScheduler.finish_reasons = property(
    lambda self: self.metrics.counters_with_prefix("sched.finish."),
    doc="finish-reason tallies, reconstructed from the "
        "'sched.finish.<reason>' registry counters")
