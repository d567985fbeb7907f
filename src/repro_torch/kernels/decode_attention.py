"""B6 + B7: ragged flash-decode against ring and paged KV caches.

Kernel: ``csrc/decode_attention.cu`` (replaces
repro/kernels/decode_attention.py ``decode_attention`` and
``decode_attention_paged``).  Four entry points, one count each:

  decode_attention            ring cache, fp32 or bf16
  decode_attention_q8         ring cache, int8 with per-slot fp32 scales
  decode_attention_paged      page pool + page table, fp32 or bf16
  decode_attention_paged_q8   page pool, int8 with per-slot scale pools

A CPU tensor takes the plain version in ``repro_torch.kernels.ref``; a
CUDA tensor launches the kernel or raises.  The checks read tensor
metadata only: ``valid_len`` stays on the device (reading it would be a
host sync per layer), so the kernel itself clamps it to the capacity and
writes NaN for a lane whose ``valid_len`` is below 1.  Caches are read by
strides with head_dim contiguous, so a layer view ``cache[l]`` of an
(L, ...) cache passes without a copy.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import CudaKernel, ptr

CACHE_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

RING = CudaKernel("dlk_decode_attention",
                  [_P] * 5 + [_I] * 6 + [_L] * 3)
RING_Q8 = CudaKernel("dlk_decode_attention_q8",
                     [_P] * 7 + [_I] * 5 + [_L] * 6)
PAGED = CudaKernel("dlk_decode_attention_paged",
                   [_P] * 6 + [_I] * 8 + [_L] * 3)
PAGED_Q8 = CudaKernel("dlk_decode_attention_paged_q8",
                      [_P] * 8 + [_I] * 7 + [_L] * 6)


def _split_layout(shape, layout):
    """(outer, slots, KV, D) of a 4D bskd/bksd cache or pool."""
    if layout == "bskd":
        return shape[0], shape[1], shape[2], shape[3]
    if layout == "bksd":
        return shape[0], shape[2], shape[1], shape[3]
    raise ValueError(f"unknown layout {layout!r}")


def _strides(t, layout):
    """(outer, head, slot) element strides; head_dim must be contiguous."""
    st = t.stride()
    if t.ndim == 4 and st[3] != 1:
        raise ValueError("decode_attention: head_dim must be contiguous")
    if min(st) < 0:
        raise ValueError("decode_attention: negative strides")
    if layout == "bskd":
        return st[0], st[2], st[1]
    return st[0], st[1], st[2]


def _check(q, k, v, layout, scales=None):
    """Validate devices, dtypes and shapes from metadata; return
    (outer, slots, KV, G, D) and q as fp32."""
    if q.ndim != 3 or k.ndim != 4:
        raise ValueError(f"decode_attention: q (B,H,D) and 4D caches, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}")
    if tuple(k.shape) != tuple(v.shape) or k.stride() != v.stride() \
            or k.dtype != v.dtype:
        raise ValueError("decode_attention: k and v must share shape, "
                         "strides and dtype")
    outer, slots, kvh, d = _split_layout(k.shape, layout)
    b, h, dq = q.shape
    if dq != d or h % kvh:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} against "
                         f"{kvh} KV heads of dim {d}")
    tensors = [q, k, v] + list(scales or ())
    dev = q.device
    for x in tensors:
        if x.device.type != "cuda" or x.device != dev:
            raise ValueError(f"decode_attention: tensors must share one CUDA "
                             f"device, got {[str(t.device) for t in tensors]}")
    if scales is not None:
        if k.dtype != torch.int8:
            raise TypeError(f"decode_attention: int8 cache expected, got {k.dtype}")
        ks, vs = scales
        want = tuple(k.shape[:3])
        if tuple(ks.shape) != want or tuple(vs.shape) != want \
                or ks.stride() != vs.stride():
            raise ValueError(f"decode_attention: scales {tuple(ks.shape)}, "
                             f"{tuple(vs.shape)} for a cache {tuple(k.shape)}")
        if ks.dtype != torch.float32 or vs.dtype != torch.float32:
            raise TypeError("decode_attention: scales must be float32")
    elif k.dtype not in CACHE_DTYPES:
        raise TypeError(f"decode_attention: cache dtype {k.dtype} "
                        f"(float32 or bfloat16; int8 takes scales)")
    if d > 256 or h // kvh > 32:
        raise ValueError(f"decode_attention: head_dim {d} > 256 or "
                         f"{h // kvh} query heads per KV head > 32")
    return outer, slots, kvh, h // kvh, d, q.float().contiguous()


def _valid(valid_len, b, device) -> torch.Tensor:
    """valid_len as a contiguous (B,) int32 device tensor, no host read."""
    if isinstance(valid_len, int):
        if valid_len < 1:
            raise ValueError(f"decode_attention: valid_len {valid_len} < 1")
        return torch.full((b,), valid_len, dtype=torch.int32, device=device)
    if not isinstance(valid_len, torch.Tensor) or valid_len.device != device:
        raise ValueError("decode_attention: valid_len must be an int or a "
                         "tensor on the cache's device")
    if valid_len.dtype.is_floating_point or valid_len.numel() not in (1, b) \
            or valid_len.ndim > 1:
        raise ValueError(f"decode_attention: valid_len {tuple(valid_len.shape)} "
                         f"{valid_len.dtype} for {b} lanes")
    return valid_len.to(torch.int32).reshape(-1).expand(b).contiguous()


def _table(page_table, b, device) -> torch.Tensor:
    if page_table.ndim != 2 or page_table.shape[0] != b:
        raise ValueError(f"decode_attention: page table "
                         f"{tuple(page_table.shape)} for {b} lanes")
    if page_table.device != device:
        raise ValueError("decode_attention: page table on another device")
    if page_table.dtype.is_floating_point:
        raise TypeError("decode_attention: integer page table expected")
    return page_table.to(torch.int32).contiguous()


def decode_attention(q, k, v, valid_len, *, layout: str = "bskd"):
    """q: (B, H, D); k, v: (B, S, KV, D) ('bskd') or (B, KV, S, D)
    ('bksd') in fp32 or bf16; valid_len: int or per-lane (B,), >= 1.
    Returns (B, H, D) in q's dtype."""
    if q.device.type == "cpu":
        return ref.decode_attention_ref(q, k, v, valid_len, layout=layout)
    outer, slots, kvh, g, d, qf = _check(q, k, v, layout)
    if outer != q.shape[0]:
        raise ValueError(f"decode_attention: {outer} cache lanes for "
                         f"{q.shape[0]} queries")
    vl = _valid(valid_len, q.shape[0], q.device)
    out = torch.empty_like(qf)
    RING.launch(q.device, ptr(qf), ptr(k), ptr(v), ptr(vl), ptr(out),
                q.shape[0], kvh, g, d, slots, CACHE_DTYPES[k.dtype],
                *_strides(k, layout))
    return out.to(q.dtype)


def decode_attention_q8(q, k, v, k_scale, v_scale, valid_len, *,
                        layout: str = "bskd"):
    """Int8 K/V with one fp32 scale per (lane, head, slot): scales
    (B, S, KV) ('bskd') or (B, KV, S) ('bksd')."""
    if q.device.type == "cpu":
        return ref.decode_attention_q8_ref(q, k, v, k_scale, v_scale,
                                           valid_len, layout=layout)
    outer, slots, kvh, g, d, qf = _check(q, k, v, layout, (k_scale, v_scale))
    if outer != q.shape[0]:
        raise ValueError(f"decode_attention: {outer} cache lanes for "
                         f"{q.shape[0]} queries")
    vl = _valid(valid_len, q.shape[0], q.device)
    out = torch.empty_like(qf)
    cs = k_scale.stride()
    c = (cs[0], cs[2], cs[1]) if layout == "bskd" else (cs[0], cs[1], cs[2])
    RING_Q8.launch(q.device, ptr(qf), ptr(k), ptr(v), ptr(k_scale),
                   ptr(v_scale), ptr(vl), ptr(out), q.shape[0], kvh, g, d,
                   slots, *_strides(k, layout), *c)
    return out.to(q.dtype)


def decode_attention_paged(q, k, v, page_table, valid_len, *,
                           layout: str = "bskd"):
    """Page pools k, v: (P, ps, KV, D) ('bskd') or (P, KV, ps, D)
    ('bksd'); page_table (B, W): lane b's logical slot t lives at pool
    page ``page_table[b, t // ps]``, offset ``t % ps``."""
    if q.device.type == "cpu":
        return ref.decode_attention_paged_ref(q, k, v, page_table,
                                              valid_len, layout=layout)
    pages, ps, kvh, g, d, qf = _check(q, k, v, layout)
    b = q.shape[0]
    pt = _table(page_table, b, q.device)
    vl = _valid(valid_len, b, q.device)
    out = torch.empty_like(qf)
    PAGED.launch(q.device, ptr(qf), ptr(k), ptr(v), ptr(pt), ptr(vl),
                 ptr(out), b, kvh, g, d, pt.shape[1], ps, pages,
                 CACHE_DTYPES[k.dtype], *_strides(k, layout))
    return out.to(q.dtype)


def decode_attention_paged_q8(q, k, v, k_scale, v_scale, page_table,
                              valid_len, *, layout: str = "bskd"):
    """Paged int8 pools with per-slot fp32 scale pools (P, ps, KV) /
    (P, KV, ps), read through the same table."""
    if q.device.type == "cpu":
        return ref.decode_attention_paged_q8_ref(
            q, k, v, k_scale, v_scale, page_table, valid_len, layout=layout)
    pages, ps, kvh, g, d, qf = _check(q, k, v, layout, (k_scale, v_scale))
    b = q.shape[0]
    pt = _table(page_table, b, q.device)
    vl = _valid(valid_len, b, q.device)
    out = torch.empty_like(qf)
    cs = k_scale.stride()
    c = (cs[0], cs[2], cs[1]) if layout == "bskd" else (cs[0], cs[1], cs[2])
    PAGED_Q8.launch(q.device, ptr(qf), ptr(k), ptr(v), ptr(k_scale),
                    ptr(v_scale), ptr(pt), ptr(vl), ptr(out), b, kvh, g, d,
                    pt.shape[1], ps, pages, *_strides(k, layout), *c)
    return out.to(q.dtype)

