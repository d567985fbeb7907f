"""Build the CUDA kernels under ``csrc/`` and bind them with ctypes.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` (one process per
source, all started together) and linked into one shared library with a
plain C interface.  The library goes to ``build/kernels/`` at the root of
the checkout (listed in ``.gitignore``), named by a hash of the sources and
flags, so a changed source is rebuilt and an unchanged one is loaded as it
is.  Nothing is built when a module is imported: the first launch of a
kernel builds, or :func:`build` does so explicitly.

A kernel is a :class:`CudaKernel`: one C entry point that returns
``cudaGetLastError()``, plus a plain count of its launches.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
import time
from typing import List, Optional, Sequence

import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_library: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None   # wall time of the last build, None if loaded as built


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit on the machine that has the card")


def _sources() -> List[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> pathlib.Path:
    return BUILD_DIR / f"libdlk_kernels-{_digest()}.so"


def _compile(out: pathlib.Path) -> str:
    """Compile every source in parallel, link, and return the compiler's
    output (ptxas register and shared-memory report included)."""
    global build_seconds
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in _sources():
            obj = pathlib.Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log = []
        failed = []
        for src, proc in procs:
            text, _ = proc.communicate()
            log.append(f"== {src.name}\n{text}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        staged = pathlib.Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             *map(str, objs), "-o", str(staged)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(staged, out)       # atomic: a concurrent loader sees all or nothing
    build_seconds = time.perf_counter() - t0
    text = "\n".join(log)
    out.with_suffix(".log").write_text(text)
    return text


def build() -> pathlib.Path:
    """Build the library if its sources changed, load it, return its path."""
    global _library
    with _lock:
        path = library_path()
        if _library is None:
            if not path.exists():
                _compile(path)
            _library = ctypes.CDLL(str(path))
            _library.dlk_error_string.argtypes = [ctypes.c_int]
            _library.dlk_error_string.restype = ctypes.c_char_p
        return path


def build_log() -> str:
    """The compiler's report from the build of the current sources."""
    log = library_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""


class CudaKernel:
    """One C entry point of the kernel library and the count of its launches.

    ``launch`` passes pointers as ``c_void_p`` (from ``data_ptr()``), ints
    as the declared ctypes, and the current stream last; it raises when the
    entry point returns a CUDA error and counts only launches that did not.
    """

    def __init__(self, symbol: str, argtypes: Sequence):
        self.symbol = symbol
        self.argtypes = list(argtypes) + [ctypes.c_void_p]   # + stream
        self.launches = 0
        self._fn = None

    def launch(self, device, *args) -> None:
        if self._fn is None:
            build()
            fn = getattr(_library, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        stream = torch.cuda.current_stream(device).cuda_stream
        err = self._fn(*args, stream)
        if err != 0:
            msg = _library.dlk_error_string(err).decode()
            raise RuntimeError(f"{self.symbol} failed to launch: {msg} ({err})")
        self.launches += 1


class CompositeKernel:
    """A wrapper whose kernel is another one of the library (B2 conv2d is
    im2col + the B1 launch): it counts its own launches beside the
    count of the kernel it goes through."""

    def __init__(self, via: CudaKernel):
        self.via = via
        self.launches = 0


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def check_cuda_f32(name: str, *tensors) -> None:
    """Raise unless every tensor is fp32 on one CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: tensors must share one CUDA device, "
                             f"got {[str(x.device) for x in tensors]}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: kernel takes float32, got {t.dtype}")
