"""B10: the chunked RWKV-6 WKV from a zero state.

Kernel: ``csrc/rwkv6_chunk.cu`` (replaces repro/kernels/rwkv6_chunk.py
``rwkv6_chunked``, body ``_wkv_kernel``).  r, k, v, w are (B, T, H, N)
fp32 or bf16 (fp32 arithmetic), u is (H, N); the result is out
(B, T, H, N) in the inputs' dtype and the final state (B, H, N, N) fp32.
Head sizes 32 and 64; T need not be a multiple of the 16-token chunk (the
kernel masks the ragged end, where the TPU wrapper pads by a copy).

A CPU tensor takes the plain version (``ref.rwkv6_chunked_ref``, the
model's ``wkv_chunked``); a CUDA tensor launches the kernel or raises.
There is no initial state and no backward: the model's ``wkv_named``
takes the plain version for those.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import CudaKernel

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_SIZES = (32, 64)
_P = ctypes.c_void_p
_I = ctypes.c_int

KERNEL = CudaKernel("dlk_rwkv6_chunked", [_P] * 7 + [_I] * 5)


def _check(r, k, v, w, u):
    """Validate devices, dtypes and shapes from metadata; return
    (B, T, H, N) and the inputs ready for a launch (u as fp32)."""
    name = "rwkv6_chunked"
    shape = tuple(r.shape)
    if r.ndim != 4 or any(tuple(x.shape) != shape for x in (k, v, w)):
        raise ValueError(f"{name}: r, k, v, w must share one (B, T, H, N) "
                         f"shape, got {[tuple(x.shape) for x in (r, k, v, w)]}")
    b, t, h, n = shape
    if tuple(u.shape) != (h, n):
        raise ValueError(f"{name}: u must be (H, N) = {(h, n)}, got "
                         f"{tuple(u.shape)}")
    tensors = (r, k, v, w, u)
    dev = r.device
    for x in tensors:
        if x.device.type != "cuda" or x.device != dev:
            raise ValueError(f"{name}: tensors must share one CUDA device, "
                             f"got {[str(y.device) for y in tensors]}")
    if r.dtype not in DTYPES or any(x.dtype != r.dtype for x in (k, v, w)):
        raise TypeError(f"{name}: float32 or bfloat16 r, k, v, w of one "
                        f"dtype, got {[x.dtype for x in (r, k, v, w)]}")
    if n not in HEAD_SIZES:
        raise ValueError(f"{name}: head size N {n} (the kernel takes "
                         f"{HEAD_SIZES})")
    if b < 1 or t < 1 or h < 1:
        raise ValueError(f"{name}: empty input {shape}")
    ready = [x.contiguous() for x in (r, k, v, w)]
    return shape, ready + [u.float().contiguous()]


def rwkv6_chunked(r, k, v, w, u):
    """r, k, v, w (B, T, H, N), u (H, N) -> (out (B, T, H, N) in r's
    dtype, state (B, H, N, N) fp32), from a zero state."""
    if r.device.type == "cpu":
        return ref.rwkv6_chunked_ref(r, k, v, w, u)
    (b, t, h, n), _ = _check(r, k, v, w, u)
    out = torch.empty((b, t, h, n), dtype=r.dtype, device=r.device)
    state = torch.empty((b, h, n, n), dtype=torch.float32, device=r.device)
    return rwkv6_chunked_into(r, k, v, w, u, out, state)


def rwkv6_chunked_into(r, k, v, w, u, out, state):
    """B10 writing into the caller's contiguous ``out`` (B, T, H, N) in
    r's dtype and ``state`` (B, H, N, N) fp32: every row t < T of ``out``
    and every element of ``state``, and nothing else.  Returns them."""
    (b, t, h, n), (r, k, v, w, u) = _check(r, k, v, w, u)
    for what, x, shape, dtype in (("out", out, (b, t, h, n), r.dtype),
                                  ("state", state, (b, h, n, n),
                                   torch.float32)):
        if tuple(x.shape) != shape or x.dtype != dtype \
                or x.device != r.device or not x.is_contiguous():
            raise ValueError(f"rwkv6_chunked: {what} must be contiguous "
                             f"{dtype} {shape} on {r.device}, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
    KERNEL.launch(r.get_device(), r.data_ptr(), k.data_ptr(), v.data_ptr(),
                  w.data_ptr(), u.data_ptr(), out.data_ptr(),
                  state.data_ptr(), b, t, h, n, DTYPES[r.dtype])
    return out, state
