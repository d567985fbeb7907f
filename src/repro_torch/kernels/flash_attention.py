"""B8 + B9: full-sequence flash attention, its forward with logsumexp and
its FlashAttention-2 backward kernels.

Kernel: ``csrc/flash_attention.cu`` (replaces
repro/kernels/flash_attention.py ``flash_attention`` and the three
``pallas_call``s of repro/kernels/flash_attention_bwd.py).  Four entry
points, one count each:

  flash_attention       B8: o, for prefill and forward passes without grad
  flash_attention_fwd   B9's forward: o and lse (B, H, S) fp32
  flash_attention_dq    B9's dq
  flash_attention_dkv   B9's dk and dv, summed over each KV head's group

q is (B, S, H, D), k and v (B, S, KV, D), fp32 or bf16, head_dim 32, 64
or 128; S need not be a multiple of the kernel's 64-row tiles.  A CPU
tensor takes the plain versions in ``repro_torch.kernels.ref``; a CUDA
tensor launches the kernel or raises.  Inputs are made contiguous (and
16-byte aligned) before a launch; outputs come back in the inputs'
dtypes.  The differentiable entry point is
``repro_torch.kernels.flash_attention_bwd.flash_attention_trainable``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import CudaKernel, ptr

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128)
_P = ctypes.c_void_p
_I = ctypes.c_int

FWD = CudaKernel("dlk_flash_attention", [_P] * 4 + [_I] * 8)
FWD_LSE = CudaKernel("dlk_flash_attention_fwd", [_P] * 5 + [_I] * 8)
DQ = CudaKernel("dlk_flash_attention_dq", [_P] * 7 + [_I] * 8)
DKV = CudaKernel("dlk_flash_attention_dkv", [_P] * 8 + [_I] * 8)


def _ready(x):
    """Contiguous, with a 16-byte aligned start (the kernel reads 16-byte
    vectors)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _check(name, q, k, v, *more):
    """Validate devices, dtypes and shapes from metadata; return
    (B, S, H, KV, D) and the inputs ready for a launch."""
    if q.ndim != 4 or k.ndim != 4 or tuple(k.shape) != tuple(v.shape):
        raise ValueError(f"{name}: q (B,S,H,D) and k, v (B,S,KV,D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h, d = q.shape
    kvh = k.shape[2]
    if k.shape[0] != b or k.shape[1] != s or k.shape[3] != d or h % kvh:
        raise ValueError(f"{name}: q {tuple(q.shape)} against k "
                         f"{tuple(k.shape)} (same B, S and D; H a multiple "
                         f"of KV)")
    tensors = (q, k, v) + more
    dev = q.device
    for x in tensors:
        if x.device.type != "cuda" or x.device != dev:
            raise ValueError(f"{name}: tensors must share one CUDA device, "
                             f"got {[str(t.device) for t in tensors]}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: float32 or bfloat16 q, k, v of one dtype, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {d} (the kernel takes "
                         f"{HEAD_DIMS})")
    if s < 1:
        raise ValueError(f"{name}: empty sequence")
    return (b, s, h, kvh, d), [_ready(x) for x in tensors]


def _mask_args(causal, window):
    if window < 0:
        raise ValueError(f"flash_attention: window {window} < 0")
    return int(bool(causal)), int(window)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """B8: q (B, S, H, D), k, v (B, S, KV, D) -> o (B, S, H, D) in q's
    dtype; causal and/or sliding-window masks (window 0 = none)."""
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    (b, s, h, kvh, d), (q, k, v) = _check("flash_attention", q, k, v)
    c, w = _mask_args(causal, window)
    o = torch.empty_like(q)
    FWD.launch(q.device, ptr(q), ptr(k), ptr(v), ptr(o), b, s, h, kvh, d,
               DTYPES[q.dtype], c, w)
    return o


def flash_fwd_lse(q, k, v, *, causal: bool = True, window: int = 0):
    """B9's forward: (o in q's dtype, lse (B, H, S) fp32)."""
    if q.device.type == "cpu":
        return ref.flash_fwd_lse_ref(q, k, v, causal=causal, window=window)
    (b, s, h, kvh, d), (q, k, v) = _check("flash_attention_fwd", q, k, v)
    c, w = _mask_args(causal, window)
    o = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    FWD_LSE.launch(q.device, ptr(q), ptr(k), ptr(v), ptr(o), ptr(lse), b, s,
                   h, kvh, d, DTYPES[q.dtype], c, w)
    return o, lse


def dsum_of(o, do):
    """rowsum(dO * o) as (B, H, S) fp32, in torch as the reference does
    outside its kernels."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


def _check_bwd(name, q, k, v, do, lse, dsum):
    dims, (q, k, v, do) = _check(name, q, k, v, do)
    b, s, h, _, d = dims
    if tuple(do.shape) != tuple(q.shape):
        raise ValueError(f"{name}: dO {tuple(do.shape)} must match q "
                         f"{tuple(q.shape)}")
    if do.dtype != q.dtype:
        raise TypeError(f"{name}: dO in q's dtype {q.dtype}, got {do.dtype}")
    for what, x in (("lse", lse), ("dsum", dsum)):
        if x.device != q.device or x.dtype != torch.float32 \
                or tuple(x.shape) != (b, h, s):
            raise ValueError(f"{name}: {what} must be float32 (B, H, S) = "
                             f"{(b, h, s)} on q's device, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
    return dims, (q, k, v, do, _ready(lse), _ready(dsum))


def flash_dq(q, k, v, do, lse, dsum, *, causal: bool = True, window: int = 0):
    """B9's dq (B, S, H, D) in q's dtype, from dO, lse and
    dsum = rowsum(dO * o) (:func:`dsum_of`), both (B, H, S) fp32."""
    if q.device.type == "cpu":
        return ref.flash_dq_ref(q, k, v, do, lse, dsum, causal=causal,
                                window=window)
    (b, s, h, kvh, d), (q, k, v, do, lse, dsum) = _check_bwd(
        "flash_attention_dq", q, k, v, do, lse, dsum)
    c, w = _mask_args(causal, window)
    dq = torch.empty_like(q)
    DQ.launch(q.device, ptr(q), ptr(k), ptr(v), ptr(do), ptr(lse), ptr(dsum),
              ptr(dq), b, s, h, kvh, d, DTYPES[q.dtype], c, w)
    return dq


def flash_dkv(q, k, v, do, lse, dsum, *, causal: bool = True,
              window: int = 0):
    """B9's (dk, dv) (B, S, KV, D) in k's dtype, each summed over the G
    query heads of its KV head; dO, lse and dsum as for :func:`flash_dq`."""
    if q.device.type == "cpu":
        return ref.flash_dkv_ref(q, k, v, do, lse, dsum, causal=causal,
                                 window=window)
    (b, s, h, kvh, d), (q, k, v, do, lse, dsum) = _check_bwd(
        "flash_attention_dkv", q, k, v, do, lse, dsum)
    c, w = _mask_args(causal, window)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    DKV.launch(q.device, ptr(q), ptr(k), ptr(v), ptr(do), ptr(lse), ptr(dsum),
               ptr(dk), ptr(dv), b, s, h, kvh, d, DTYPES[q.dtype], c, w)
    return dk, dv
