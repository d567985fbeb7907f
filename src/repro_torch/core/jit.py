"""CUDA graphs: the port's twin of ``jax.jit``.

The JAX package compiles a step once per shape and runs the compiled
program after that: ``Graph.jit_apply`` for the CNN engine, the
scheduler's decode step.  On a CUDA device the port captures such a step
once as a ``torch.cuda.CUDAGraph`` and replays it, so a step costs the
host one graph launch instead of one launch per kernel.  The hand-written
kernels and their order are the same as in the eager step.

:func:`capture` runs the step once for real on the device's capture
stream, so that every plan and workspace the kernel wrappers cache
(they key some on the stream) exists before the capture, then captures
the step on that same stream.  The launches that the capture records run
nothing, so they leave the kernels' counts and are added back at every
replay (``kernels._build.recorded_launches``).  Graphs given one
``pool`` (``torch.cuda.graph_pool_handle()``) share their memory: safe for
programs that write every result into tensors outside the pool and
return nothing from it, replayed one at a time on one stream.

:func:`disable_graphs` is the twin of ``jax.disable_jit()``: inside it
every step runs eagerly.  It is the only eager route on a CUDA device:
a capture or a replay that fails raises.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Any, Callable, Dict, Iterator, Tuple

import torch

from repro_torch.kernels._build import add_launches, recorded_launches

_local = threading.local()          # disable_graphs() depth, per thread
_STREAMS: Dict[int, "torch.cuda.Stream"] = {}


@contextmanager
def disable_graphs() -> Iterator[None]:
    """Run every step eagerly inside this block (it nests, and restores
    the state it found on exit)."""
    depth = getattr(_local, "disabled", 0)
    _local.disabled = depth + 1
    try:
        yield
    finally:
        _local.disabled = depth


def graphs_enabled() -> bool:
    """False inside :func:`disable_graphs`."""
    return not getattr(_local, "disabled", 0)


def _capture_stream(device: torch.device) -> "torch.cuda.Stream":
    """One side stream a device for every warm-up and capture, so the
    workspaces that the kernel wrappers keep per stream stay few."""
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    stream = _STREAMS.get(index)
    if stream is None:
        stream = _STREAMS[index] = torch.cuda.Stream(index)
    return stream


class Captured:
    """A captured step: its graph, what the step returned while it was
    captured (static tensors that every replay writes again), the kernel
    launches it holds and how many times it was replayed."""

    def __init__(self, graph: "torch.cuda.CUDAGraph", outputs: Any,
                 launches: Tuple):
        self.graph = graph
        self.outputs = outputs
        self.launches = launches
        self.replays = 0

    def replay(self) -> Any:
        """Run the graph on the current stream; return its static outputs."""
        self.graph.replay()
        add_launches(self.launches)
        self.replays += 1
        return self.outputs


def capture(step: Callable[[], Any], device,
            pool=None) -> Tuple[Any, Captured]:
    """Run ``step()`` once on the device's capture stream, then capture
    it there, in memory ``pool`` when given (else a pool of its own).
    Returns what the run returned (valid on the current stream) and the
    :class:`Captured` graph.  The run waits for the current stream's
    earlier work, and the current stream for the run."""
    current = torch.cuda.current_stream(device)
    side = _capture_stream(device)
    side.wait_stream(current)
    with torch.cuda.stream(side):
        out = step()
    graph = torch.cuda.CUDAGraph()
    with recorded_launches() as held:
        with torch.cuda.graph(graph, pool=pool, stream=side):
            static = step()
    current.wait_stream(side)
    if isinstance(out, torch.Tensor):
        out.record_stream(current)
    return out, Captured(graph, static, tuple(held))
