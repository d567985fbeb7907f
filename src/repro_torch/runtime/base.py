"""Device runtime: residency, pipeline cache, stats, command queue.

The port of ``repro.runtime.base`` on CUDA.  The paper's seven-row
Metal/OpenCL table maps here as:

    1 MTLCreateSystemDefaultDevice  -> torch.device (cuda unless the caller
                                       asks for the CPU)
    2 newCommandQueue               -> in-order list of CommandBuffers over
                                       the device's current stream
    3 newDefaultLibrary             -> repro_torch.kernels (the CUDA library)
    4 newFunctionWithName           -> one callable per model (the graph's
                                       compiled_apply)
    5 newBufferWithBytes            -> pinned host copy, non-blocking to
                                       the device
    6 commandBuffer.commit          -> dispatch(): launch, record an event
    7 waitUntilCompleted            -> synchronise that event

Weights stay device-resident across calls, and the runtime counts the
host->device bytes it avoided.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.modelstore import ModelStore, ResidentCache
from repro_torch.core.quantize import tree_bytes


def resolve_device(device) -> torch.device:
    """The runtime's device; a CUDA device must exist, there is no fallback."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


@dataclass
class CommandBuffer:
    """One enqueued execution — mirrors MTLCommandBuffer."""
    model: str
    result: Any = None            # output tensor, valid once completed
    committed_at: float = 0.0
    completed_at: Optional[float] = None
    event: Optional[torch.cuda.Event] = None   # None on the CPU (synchronous)

    def wait_until_completed(self):
        if self.event is not None:
            self.event.synchronize()
        self.completed_at = time.perf_counter()
        return self.result


class DeviceRuntime:
    """Store-backed device residency + pipeline cache + in-order command
    queue, shared by every executor."""

    def __init__(self, store: Optional[ModelStore] = None, *,
                 max_resident: int = 2, device="cuda"):
        self.device = resolve_device(device)               # table row 1
        self.cache = (ResidentCache(store, capacity=max_resident,
                                    device=self.device)
                      if store is not None else None)
        self.queue: List[CommandBuffer] = []                # table row 2
        self._pipelines: Dict[Any, Callable] = {}           # table row 4
        self.stats = {"switches": 0, "dispatches": 0,
                      "weight_bytes_avoided": 0, "active_model": None}
        # bounded: activate() runs per dispatch on the hot path, and an
        # unbounded log would grow forever in a long-running service
        self.switch_log: Deque[Tuple[str, float]] = deque(maxlen=4096)

    # -- residency ----------------------------------------------------------

    def activate(self, name: str, version: Optional[str] = None):
        """Resolve a model from the store through the LRU device cache,
        recording switch count and switch latency."""
        if self.cache is None:
            raise RuntimeError("runtime has no model store")
        t0 = time.perf_counter()
        rec, spec, params = self.cache.get(name, version)
        if self.stats["active_model"] != name:
            self.stats["switches"] += 1
            self.stats["active_model"] = name
        self.switch_log.append((name, time.perf_counter() - t0))
        return rec, spec, params

    # -- pipeline-state objects ---------------------------------------------

    def pipeline(self, key, params, build: Callable[[], Callable]
                 ) -> Callable:
        """Pipeline cache.  On a hit the weights are already
        device-resident, so count the host->device copy we did NOT do."""
        if key in self._pipelines:
            self.stats["weight_bytes_avoided"] += tree_bytes(params)
            return self._pipelines[key]
        fn = build()
        self._pipelines[key] = fn
        return fn

    # -- command queue ------------------------------------------------------

    def put(self, x) -> torch.Tensor:
        """Host data -> the device (table row 5): a pinned host copy and a
        non-blocking transfer on the current stream."""
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        if x.device == self.device:
            return x
        if self.device.type == "cuda" and x.device.type == "cpu":
            return x.pin_memory().to(self.device, non_blocking=True)
        return x.to(self.device)

    def dispatch(self, model: str, fn: Callable, *args) -> CommandBuffer:
        """commit(): launch without blocking, then record an event."""
        cb = CommandBuffer(model=model, committed_at=time.perf_counter())
        cb.result = fn(*args)                               # table row 6
        if self.device.type == "cuda":
            cb.event = torch.cuda.Event()
            cb.event.record(torch.cuda.current_stream(self.device))
        self.stats["dispatches"] += 1
        self.queue.append(cb)
        return cb

    def fence(self):
        """waitUntilCompleted for everything in flight (table row 7)."""
        done = [cb.wait_until_completed() for cb in self.queue]
        self.queue.clear()
        return done
