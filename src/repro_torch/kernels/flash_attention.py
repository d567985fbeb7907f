"""B8 + B9: full-sequence flash attention, its forward with logsumexp and
its FlashAttention-2 backward kernels.

Kernel: ``csrc/flash_attention.cu`` (replaces
repro/kernels/flash_attention.py ``flash_attention`` and the three
``pallas_call``s of repro/kernels/flash_attention_bwd.py).  Four entry
points, one count each:

  flash_attention       B8: o, for prefill and forward passes without grad
  flash_attention_fwd   B9's forward: o and lse (B, H, Sq) fp32
  flash_attention_dq    B9's dq
  flash_attention_dkv   B9's dk and dv, summed over each KV head's group

The forward (both entry points) runs 3xTF32 on the warpgroup tensor
cores (``wgmma``): ``flash_fwd_tc`` up to head_dim 128, ``flash_fwd_tc256``
(two warpgroups) at 256.  dq and dk/dv run 3xTF32 on ``mma.sync`` up to
128 and fp32 FFMA at 256.

q is (B, Sq, H, D), k and v (B, Sk, KV, D), fp32 or bf16, head_dim 32,
64, 128 or 256; Sq and Sk need not be equal nor multiples of the
kernel's tiles, and query positions start at 0 (the Pallas kernels'
masks).  A CPU tensor takes the plain versions in
``repro_torch.kernels.ref``; a CUDA tensor launches the kernel or
raises; a meta tensor takes the CUDA path's checks and allocations and
launches nothing (the dry run's memory count, ``launch.memory``).
Inputs are made contiguous (and 16-byte aligned) before a launch, a
copy for the launch alone; outputs come back in the inputs' dtypes.

What each entry point allocates (the memory count charges it): B8 o
(B, Sq, H, D); B9's forward o and lse (B, H, Sq) fp32; dq (B, Sq, H,
D); dk and dv (B, Sk, KV, D).  No kernel keeps a buffer between
launches.  The differentiable
entry point is
``repro_torch.kernels.flash_attention_bwd.flash_attention_trainable``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import CudaKernel

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128, 256)
_P = ctypes.c_void_p
_I = ctypes.c_int

FWD = CudaKernel("dlk_flash_attention", [_P] * 4 + [_I] * 9)
FWD_LSE = CudaKernel("dlk_flash_attention_fwd", [_P] * 5 + [_I] * 9)
DQ = CudaKernel("dlk_flash_attention_dq", [_P] * 7 + [_I] * 9)
DKV = CudaKernel("dlk_flash_attention_dkv", [_P] * 8 + [_I] * 9)


def _ready(x):
    """Contiguous, with a 16-byte aligned start (the kernel reads 16-byte
    vectors)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _check(name, q, k, v, *more):
    """Validate devices, dtypes and shapes from metadata; return
    (B, Sq, Sk, H, KV, D), the device index and the inputs ready for a
    launch."""
    if q.ndim != 4 or k.ndim != 4 or tuple(k.shape) != tuple(v.shape):
        raise ValueError(f"{name}: q (B,Sq,H,D) and k, v (B,Sk,KV,D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or h % kvh:
        raise ValueError(f"{name}: q {tuple(q.shape)} against k "
                         f"{tuple(k.shape)} (same B and D; H a multiple "
                         f"of KV)")
    tensors = (q, k, v) + more
    dev = q.get_device()
    for x in tensors:
        if not (x.is_cuda or x.is_meta) or x.get_device() != dev:
            raise ValueError(f"{name}: tensors must share one CUDA device, "
                             f"got {[str(t.device) for t in tensors]}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: float32 or bfloat16 q, k, v of one dtype, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {d} (the kernel takes "
                         f"{HEAD_DIMS})")
    if sq < 1 or sk < 1:
        raise ValueError(f"{name}: empty sequence (Sq {sq}, Sk {sk})")
    return (b, sq, sk, h, kvh, d), dev, [_ready(x) for x in tensors]


def _mask_args(causal, window):
    if window < 0:
        raise ValueError(f"flash_attention: window {window} < 0")
    return int(bool(causal)), int(window)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """B8: q (B, Sq, H, D), k, v (B, Sk, KV, D) -> o (B, Sq, H, D) in q's
    dtype; causal and/or sliding-window masks (window 0 = none)."""
    if q.is_cpu:
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    dims, dev, (q, k, v) = _check("flash_attention", q, k, v)
    c, w = _mask_args(causal, window)
    o = torch.empty_like(q)
    if not q.is_meta:
        FWD.launch(dev, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                   o.data_ptr(), *dims, DTYPES[q.dtype], c, w)
    return o


def flash_fwd_lse(q, k, v, *, causal: bool = True, window: int = 0):
    """B9's forward: (o in q's dtype, lse (B, H, Sq) fp32)."""
    if q.is_cpu:
        return ref.flash_fwd_lse_ref(q, k, v, causal=causal, window=window)
    dims, dev, (q, k, v) = _check("flash_attention_fwd", q, k, v)
    b, sq, _, h, _, _ = dims
    c, w = _mask_args(causal, window)
    o = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    if not q.is_meta:
        FWD_LSE.launch(dev, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       o.data_ptr(), lse.data_ptr(), *dims, DTYPES[q.dtype],
                       c, w)
    return o, lse


def dsum_of(o, do):
    """rowsum(dO * o) as (B, H, Sq) fp32, in torch as the reference does
    outside its kernels (a (B, Sq, H, D) fp32 product and a (B, Sq, H)
    sum live while it runs)."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


def _check_bwd(name, q, k, v, do, lse, dsum):
    dims, dev, (q, k, v, do) = _check(name, q, k, v, do)
    b, sq, _, h, _, _ = dims
    if tuple(do.shape) != tuple(q.shape):
        raise ValueError(f"{name}: dO {tuple(do.shape)} must match q "
                         f"{tuple(q.shape)}")
    if do.dtype != q.dtype:
        raise TypeError(f"{name}: dO in q's dtype {q.dtype}, got {do.dtype}")
    for what, x in (("lse", lse), ("dsum", dsum)):
        if x.device != q.device or x.dtype != torch.float32 \
                or tuple(x.shape) != (b, h, sq):
            raise ValueError(f"{name}: {what} must be float32 (B, H, Sq) = "
                             f"{(b, h, sq)} on q's device, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
    return dims, dev, (q, k, v, do, _ready(lse), _ready(dsum))


def flash_dq(q, k, v, do, lse, dsum, *, causal: bool = True, window: int = 0):
    """B9's dq (B, Sq, H, D) in q's dtype, from dO, lse and
    dsum = rowsum(dO * o) (:func:`dsum_of`), both (B, H, Sq) fp32."""
    if q.is_cpu:
        return ref.flash_dq_ref(q, k, v, do, lse, dsum, causal=causal,
                                window=window)
    dims, dev, (q, k, v, do, lse, dsum) = _check_bwd(
        "flash_attention_dq", q, k, v, do, lse, dsum)
    c, w = _mask_args(causal, window)
    dq = torch.empty_like(q)
    if not q.is_meta:
        DQ.launch(dev, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  do.data_ptr(), lse.data_ptr(), dsum.data_ptr(),
                  dq.data_ptr(), *dims, DTYPES[q.dtype], c, w)
    return dq


def flash_dkv(q, k, v, do, lse, dsum, *, causal: bool = True,
              window: int = 0):
    """B9's (dk, dv) (B, Sk, KV, D) in k's dtype, each summed over the G
    query heads of its KV head; dO, lse and dsum as for :func:`flash_dq`."""
    if q.is_cpu:
        return ref.flash_dkv_ref(q, k, v, do, lse, dsum, causal=causal,
                                 window=window)
    dims, dev, (q, k, v, do, lse, dsum) = _check_bwd(
        "flash_attention_dkv", q, k, v, do, lse, dsum)
    c, w = _mask_args(causal, window)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if not q.is_meta:
        DKV.launch(dev, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                   do.data_ptr(), lse.data_ptr(), dsum.data_ptr(),
                   dk.data_ptr(), dv.data_ptr(), *dims, DTYPES[q.dtype], c,
                   w)
    return dk, dv
