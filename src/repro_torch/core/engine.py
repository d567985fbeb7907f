"""CNN inference engine on the shared device runtime.

The port of ``repro.core.engine``.  The residency / pipeline-cache /
command-queue mechanics live in ``repro_torch.runtime.base.DeviceRuntime``;
this engine adds what is CNN-specific: building a graph pipeline from an
imported DeepLearningKit-JSON model description (``Graph.jit_apply``: a
CUDA graph per input shape on the card).

The engine runs on the CUDA device unless the caller passes
``device="cpu"``; with no CUDA device it raises.  Kernel selection is by
backend name per op (``ref`` | ``cuda``); the default is ``cuda`` on a
CUDA device, so every op with a kernel runs on it, and ``ref`` on the CPU.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.graph import Backend
from repro_torch.core.importer import from_caffe_json
from repro_torch.core.modelstore import ModelStore
from repro_torch.runtime.base import CommandBuffer, DeviceRuntime

__all__ = ["CommandBuffer", "InferenceEngine"]


class InferenceEngine(DeviceRuntime):
    """Loads models from the store, keeps them device-resident, executes
    batched requests through an in-order command queue."""

    def __init__(self, store: ModelStore, *, max_resident: int = 2,
                 backend: Backend = None, device="cuda"):
        super().__init__(store, max_resident=max_resident, device=device)
        if backend is None:
            backend = "cuda" if self.device.type == "cuda" else "ref"
        self.backend = backend

    def _build_pipeline(self, spec):
        if spec.get("format") == "deeplearningkit-json-v1":
            graph, _ = from_caffe_json(spec)
            return graph.jit_apply(backend=self.backend)
        raise ValueError(f"unknown model format in spec: "
                         f"{spec.get('format')!r}")

    def load(self, name: str, version: Optional[str] = None):
        """Model switch: store -> LRU device cache -> pipeline."""
        rec, spec, params = self.activate(name, version)
        fn = self.pipeline((rec.name, rec.version), params,
                           lambda: self._build_pipeline(spec))
        return rec, spec, params, fn

    def enqueue(self, name: str, x, version: Optional[str] = None
                ) -> CommandBuffer:
        """commit(): dispatch without blocking."""
        _, _, params, fn = self.load(name, version)
        return self.dispatch(name, fn, params, self.put(x))

    def predict(self, name: str, x, version: Optional[str] = None):
        cb = self.enqueue(name, x, version)
        out = cb.wait_until_completed()
        self.queue.remove(cb)
        return out
