"""B6 + B7: ragged flash-decode against ring and paged KV caches.

Kernel: ``csrc/decode_attention.cu`` (replaces
repro/kernels/decode_attention.py ``decode_attention`` and
``decode_attention_paged``).  Four entry points, one count each:

  decode_attention            ring cache, fp32 or bf16
  decode_attention_q8         ring cache, int8 with per-slot fp32 scales
  decode_attention_paged      page pool + page table, fp32 or bf16
  decode_attention_paged_q8   page pool, int8 with per-slot scale pools

The kernel is split-KV: a CTA per (lane, KV head, chunk of ``chunk``
slots), the chunks' partial softmax states merged in split order by the
CTA that finishes last.  Groups of 16 query heads (RecurrentGemma's MQA)
take the wide route instead: both products on mma.sync in 3xTF32 with
the 16 heads as mma's M, and the splits merged in split order by a
second small kernel.  :func:`plan` fixes the route, the chunk and the
number of splits from the shapes alone; the wrapper keeps one ctypes
:class:`DecodePlan` per call geometry and one workspace per (device,
stream, B, KV, splits, G, D), so a call is the checks, the output's
allocation and one ``ctypes`` call.

A CPU tensor takes the plain version in ``repro_torch.kernels.ref``; a
CUDA tensor launches the kernel or raises; a meta tensor takes the CUDA
path's checks and allocations and launches nothing (the dry run's memory
count, ``launch.memory``).  A launch allocates its output (B, H, D) fp32
(and a copy in q's dtype where that is not fp32), an fp32 copy of q
where q is not contiguous fp32, and an int32 (B,) valid_len where it is
not one already: all per launch.  The workspace is kept: made at the
first launch of its key and live from then on.  The checks read tensor
metadata only: ``valid_len`` stays on the device (reading it would be a
host sync per layer), so the kernel itself clamps it to the capacity and
writes NaN for a lane whose ``valid_len`` is below 1.  Caches are read by
strides with head_dim contiguous, so a layer view ``cache[l]`` of an
(L, ...) cache passes without a copy; K/V rows are copied 16 bytes at a
time where the base pointers and strides allow, 8 or 4 otherwise, and a
cache that is not 4-byte aligned is refused.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import CudaKernel, _raw_stream_fn

CACHE_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_P = ctypes.c_void_p
_ARGS = [_P] * 9          # q, k, v, k_scale, v_scale, page_table, valid, out, plan

RING = CudaKernel("dlk_decode_attention", _ARGS)
RING_Q8 = CudaKernel("dlk_decode_attention_q8", _ARGS)
PAGED = CudaKernel("dlk_decode_attention_paged", _ARGS)
PAGED_Q8 = CudaKernel("dlk_decode_attention_paged_q8", _ARGS)

THREADS = 128             # threads a CTA (csrc/decode_attention.cu)
CHUNK = 64                # slots a split, where shared memory allows (PERF.md)
MAX_CHUNK = THREADS       # one score thread per slot at least
SMEM_BUDGET = 112 * 1024  # two CTAs an SM
MAX_HEAD_DIM = 256
MAX_GROUP = 32
# the wide route: G = 16 (mma's M) and head_dim a multiple of 32 (four
# warps' n-tiles of 8 columns); chunks a multiple of 32 up to 128, 64 by
# default for every element size: at RecurrentGemma's live lanes one
# CTA's chain sets the time, and chunks of 128 took 1.4x as long as 64
# for paged int8 (PERF.md); one CTA an SM
WIDE_GROUP = 16
WIDE_CHUNK = 64
WIDE_SMEM_BUDGET = 200 * 1024


class DecodePlan(ctypes.Structure):
    """One call geometry as the entry points read it (``struct
    DlkDecodePlan`` in ``csrc/decode_attention.cu``, field for field)."""
    _fields_ = ([(n, ctypes.c_longlong) for n in (
        "s_outer", "s_head", "s_slot", "c_outer", "c_head", "c_slot")]
        + [("ws", ctypes.c_void_p)]
        + [(n, ctypes.c_int) for n in (
            "B", "KV", "G", "D", "slots", "W", "n_outer", "dtype", "chunk",
            "n_split", "vw", "wide")]
        + [("scale", ctypes.c_float)])


class Split(NamedTuple):
    """The split-KV arithmetic of one call: ``chunk`` slots a split,
    ``n_split`` splits over ``capacity`` slots, the shared memory a CTA
    takes, the workspace's size in 4-byte words (the per-(lane, KV head)
    counters, then each split's partial acc (G x D) and (m, l) (2 x G))
    and the route (``wide``: the mma.sync kernel and its merge kernel,
    which take no tickets)."""
    chunk: int
    n_split: int
    capacity: int
    smem: int
    ws_words: int
    wide: bool = False


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def smem_bytes(g: int, d: int, chunk: int, elem: int, scaled: bool) -> int:
    """Shared memory of one CTA (``smem_layout`` in the source): q, the K
    and V rows (each an odd multiple of 16 bytes), the scores, m and l, the
    int8 scales and the slot groups' partial sums."""
    r16 = _cdiv(d * elem, 16)
    row = 16 * (r16 + 1 - r16 % 2)
    n = 4 * g * d + 2 * chunk * row + 4 * g * (chunk + 1) + 8 * g
    if scaled:
        n += 8 * chunk
    return _cdiv(n, 16) * 16 + 16 * THREADS


def wide_smem_bytes(d: int, chunk: int, elem: int, scaled: bool) -> int:
    """Shared memory of one wide-route CTA (``wide_layout`` in the
    source): q (16 rows of d + 4 floats), K rows (an odd multiple of 16
    bytes), V rows (fp32: d * 4 + 32 bytes, else K's), the probabilities
    (16 rows of chunk + 4 floats), m and l, the int8 scales."""
    r16 = _cdiv(d * elem, 16)
    krow = 16 * (r16 + 1 - r16 % 2)
    vrow = d * 4 + 32 if elem == 4 else krow
    n = 4 * WIDE_GROUP * (d + 4) + chunk * (krow + vrow) \
        + 4 * WIDE_GROUP * (chunk + 4) + 8 * WIDE_GROUP
    return n + (8 * chunk if scaled else 0)


def is_wide(g: int, d: int) -> bool:
    """Shapes the wide route takes: 16 query heads a KV head (mma's M)
    and head_dim a multiple of 32, at most 256."""
    return g == WIDE_GROUP and d % 32 == 0 and d <= MAX_HEAD_DIM


def plan(b: int, kvh: int, g: int, d: int, elem: int, *, slots: int,
         page_size: Optional[int] = None, width: int = 1,
         scaled: bool = False, chunk: Optional[int] = None) -> Split:
    """The split of a call over ``b`` lanes and ``kvh`` KV heads of ``g``
    query heads of dim ``d``, K/V elements of ``elem`` bytes.  Ring:
    ``slots`` = S, the capacity.  Paged: ``page_size`` = ps and ``width``
    = W, the capacity W * ps, and the chunk a multiple of ps (or, for
    pages longer than the chunk, the largest divisor of ps under it), so
    that a CTA reads whole pages' ids once.  The route by shape: the wide
    one for :func:`is_wide` shapes, the FFMA one otherwise.  The chunk
    asked for (default WIDE_CHUNK on the wide route, CHUNK on the other)
    shrinks while a CTA's shared memory would exceed the route's budget:
    on the wide route it stays a multiple of 32 (a ValueError where the
    chunk asked for, or the page size, leaves none), on the FFMA route it
    halves.  It never depends on valid_len or on ``b``, so a lane's
    result does not either."""
    wide = is_wide(g, d)
    c = chunk if chunk is not None else (WIDE_CHUNK if wide else CHUNK)
    if not 1 <= c <= MAX_CHUNK or (wide and c % 32):
        raise ValueError(f"decode_attention: chunk {c} not in "
                         f"[1, {MAX_CHUNK}]" + (" or not a multiple of 32 "
                         "(16 query heads a KV head)" if wide else ""))
    if wide:
        while c > 32 and wide_smem_bytes(d, c, elem, scaled) > \
                WIDE_SMEM_BUDGET:
            c -= 32
    else:
        while c > 8 and smem_bytes(g, d, c, elem, scaled) > SMEM_BUDGET:
            c //= 2
    capacity = slots if page_size is None else width * page_size
    if page_size is not None:
        step = 32 * page_size // math.gcd(32, page_size) if wide else page_size
        if page_size <= c:
            c -= c % step
        else:
            unit = 32 if wide else 1
            c = max((x for x in range(unit, c + 1, unit)
                     if page_size % x == 0), default=0)
        if not c:
            raise ValueError(f"decode_attention: pages of {page_size} slots "
                             f"give no chunk that is a multiple of 32 and "
                             f"of whole pages (16 query heads a KV head)")
    n_split = _cdiv(capacity, c)
    ws = _cdiv(b * kvh, 4) * 4 + b * kvh * n_split * g * (d + 2)
    smem = wide_smem_bytes(d, c, elem, scaled) if wide else \
        smem_bytes(g, d, c, elem, scaled)
    return Split(c, n_split, capacity, smem, ws, wide)


def splits_used(p: Split, valid: int) -> int:
    """Splits that do work for a lane of ``valid`` slots: ceil(min(valid,
    capacity) / chunk), 0 for valid < 1 (the lane gets NaN)."""
    return _cdiv(min(valid, p.capacity), p.chunk) if valid >= 1 else 0


def tickets(p: Split, valid: int) -> int:
    """Tickets a lane's counter takes in one launch: one a working split
    when there are two or more, none when one split writes the output or
    on the wide route (its merge is a kernel of its own)."""
    n = splits_used(p, valid)
    return n if n > 1 and not p.wide else 0


def _split_layout(shape, layout):
    """(outer, slots, KV, D) of a 4D bskd/bksd cache or pool."""
    if layout == "bskd":
        return shape[0], shape[1], shape[2], shape[3]
    if layout == "bksd":
        return shape[0], shape[2], shape[1], shape[3]
    raise ValueError(f"unknown layout {layout!r}")


def _strides(st, layout):
    """(outer, head, slot) element strides of a cache (4D) or its scales
    (3D) from ``stride()``."""
    if layout == "bskd":
        return st[0], st[2], st[1]
    return st[0], st[1], st[2]


def vector_bytes(elem: int, d: int, strides, *pointers) -> int:
    """The widest copy (16, 8 or 4 bytes) that every K/V row start allows:
    the base pointers and the byte strides are multiples of it, and so is a
    row (head_dim x elem); 0 when not even 4 bytes are."""
    vw = 16
    for x in (d * elem, *(s * elem for s in strides), *pointers):
        while vw and x % vw:
            vw //= 2
    return vw if vw >= 4 else 0


def _check(q, k, v, layout, scales, table):
    """Validate devices, dtypes and shapes from metadata; return (device
    index, outer, slots, KV, G, D)."""
    if q.ndim != 3 or k.ndim != 4:
        raise ValueError(f"decode_attention: q (B,H,D) and 4D caches, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}")
    if k.shape != v.shape or k.stride() != v.stride() or k.dtype != v.dtype:
        raise ValueError("decode_attention: k and v must share shape, "
                         "strides and dtype")
    outer, slots, kvh, d = _split_layout(k.shape, layout)
    b, h, dq = q.shape
    if dq != d or h % kvh:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} against "
                         f"{kvh} KV heads of dim {d}")
    idx = q.get_device()
    tensors = (q, k, v) + tuple(scales or ()) + (
        (table,) if table is not None else ())
    if not (q.is_cuda or q.is_meta) or \
            any(x.device != q.device for x in tensors):
        raise ValueError(f"decode_attention: tensors must share one CUDA "
                         f"device, got {[str(t.device) for t in tensors]}")
    if k.stride(3) != 1:
        raise ValueError("decode_attention: head_dim must be contiguous")
    if min(k.stride()) < 0:
        raise ValueError("decode_attention: negative strides")
    if scales is not None:
        if k.dtype != torch.int8:
            raise TypeError(f"decode_attention: int8 cache expected, got {k.dtype}")
        ks, vs = scales
        want = k.shape[:3]
        if ks.shape != want or vs.shape != want or ks.stride() != vs.stride():
            raise ValueError(f"decode_attention: scales {tuple(ks.shape)}, "
                             f"{tuple(vs.shape)} for a cache {tuple(k.shape)}")
        if ks.dtype != torch.float32 or vs.dtype != torch.float32:
            raise TypeError("decode_attention: scales must be float32")
        if min(ks.stride()) < 0:
            raise ValueError("decode_attention: negative strides")
    elif k.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"decode_attention: cache dtype {k.dtype} "
                        f"(float32 or bfloat16; int8 takes scales)")
    if d > MAX_HEAD_DIM or h // kvh > MAX_GROUP or d % 4:
        raise ValueError(f"decode_attention: head_dim {d} (a multiple of 4, "
                         f"at most {MAX_HEAD_DIM}) and {h // kvh} query heads "
                         f"per KV head (at most {MAX_GROUP})")
    return idx, outer, slots, kvh, h // kvh, d


def _valid(valid_len, b, device) -> torch.Tensor:
    """valid_len as a contiguous (B,) int32 device tensor, no host read."""
    if isinstance(valid_len, torch.Tensor) and valid_len.dtype is torch.int32 \
            and valid_len.shape == (b,) and valid_len.device == device \
            and valid_len.is_contiguous():
        return valid_len
    if isinstance(valid_len, int):
        if valid_len < 1:
            raise ValueError(f"decode_attention: valid_len {valid_len} < 1")
        return torch.full((b,), valid_len, dtype=torch.int32, device=device)
    if not isinstance(valid_len, torch.Tensor) \
            or valid_len.device != device:
        raise ValueError("decode_attention: valid_len must be an int or a "
                         "tensor on the cache's device")
    if valid_len.dtype.is_floating_point or valid_len.numel() not in (1, b) \
            or valid_len.ndim > 1:
        raise ValueError(f"decode_attention: valid_len {tuple(valid_len.shape)} "
                         f"{valid_len.dtype} for {b} lanes")
    return valid_len.to(torch.int32).reshape(-1).expand(b).contiguous()


def _table(page_table, b) -> torch.Tensor:
    if page_table.ndim != 2 or page_table.shape[0] != b:
        raise ValueError(f"decode_attention: page table "
                         f"{tuple(page_table.shape)} for {b} lanes")
    if page_table.dtype.is_floating_point:
        raise TypeError("decode_attention: integer page table expected")
    if page_table.dtype is torch.int32 and page_table.is_contiguous():
        return page_table
    return page_table.to(torch.int32).contiguous()


# (device, stream, B, KV, n_split, G, D) -> workspace; a stream of its own
# per entry, as two streams sharing one would race on the counters
_WORKSPACES: Dict[Tuple[int, ...], torch.Tensor] = {}
# call geometry -> (plan, its address)
_PLANS: Dict[tuple, Tuple[DecodePlan, int]] = {}


def workspace(idx: int, stream: int, b: int, kvh: int, p: Split, g: int,
              d: int) -> torch.Tensor:
    """The zeroed workspace of (device, stream, B, KV, splits, G, D), made
    once: the kernel leaves its counters at 0 after every launch."""
    key = (idx, stream, b, kvh, p.n_split, g, d)
    ws = _WORKSPACES.get(key)
    if ws is None:
        dev = torch.device("cuda", idx) if idx >= 0 else torch.device("meta")
        ws = _WORKSPACES[key] = torch.zeros(p.ws_words, dtype=torch.int32,
                                            device=dev)
    return ws


def drop_meta() -> None:
    """Forget the meta workspaces and their plans (device index -1): the
    next meta call makes its workspace anew, as a first launch does."""
    for cache, at in ((_WORKSPACES, 0), (_PLANS, 1)):
        for key in [key for key in cache if key[at] == -1]:
            del cache[key]


def launch(kernel: CudaKernel, q, k, v, valid_len, *, layout: str,
           scales=None, page_table=None, chunk: Optional[int] = None):
    """The kernel on CUDA tensors.  ``chunk`` defaults to :func:`plan`'s;
    tests and the chip smoke pass others to hold every split against the
    plain version and to time them."""
    idx, outer, slots, kvh, g, d = _check(q, k, v, layout, scales, page_table)
    b = q.shape[0]
    paged = page_table is not None
    if paged:
        pt = _table(page_table, b)
        width = pt.shape[1]
    else:
        if outer != b:
            raise ValueError(f"decode_attention: {outer} cache lanes for "
                             f"{b} queries")
        pt, width = None, 1
    vl = _valid(valid_len, b, q.device)
    qf = q if q.dtype is torch.float32 and q.is_contiguous() \
        else q.float().contiguous()
    if qf.data_ptr() % 16:
        qf = qf.clone()
    kp, vp = k.data_ptr(), v.data_ptr()
    stream = _raw_stream_fn()(idx) if q.is_cuda else 0
    st = _strides(k.stride(), layout)
    cst = _strides(scales[0].stride(), layout) if scales else (0, 0, 0)
    key = (kernel.symbol, idx, stream, b, outer, slots, kvh, g, d, k.dtype,
           st, cst, width, (kp | vp) % 16, chunk)
    entry = _PLANS.get(key)
    if entry is None:
        entry = _PLANS[key] = _make_plan(idx, stream, b, outer, slots, kvh, g,
                                         d, k.element_size(), CACHE_DTYPES[k.dtype],
                                         st, cst, width, kp, vp, paged,
                                         scales is not None, chunk)
    out = qf.new_empty(qf.shape)
    ks, vs = (scales[0].data_ptr(), scales[1].data_ptr()) if scales \
        else (None, None)
    if not q.is_meta:
        kernel.launch_on(stream, qf.data_ptr(), kp, vp, ks, vs,
                         pt.data_ptr() if paged else None, vl.data_ptr(),
                         out.data_ptr(), entry[1])
    return out if q.dtype is torch.float32 else out.to(q.dtype)


def _make_plan(idx, stream, b, outer, slots, kvh, g, d, elem, code, st, cst,
               width, kp, vp, paged, scaled, chunk):
    vw = vector_bytes(elem, d, st, kp, vp)
    if not vw:
        raise ValueError("decode_attention: K/V rows must start on 4-byte "
                         "boundaries (base pointers and strides)")
    if paged:
        p = plan(b, kvh, g, d, elem, slots=slots, page_size=slots,
                 width=width, scaled=scaled, chunk=chunk)
    else:
        p = plan(b, kvh, g, d, elem, slots=slots, scaled=scaled, chunk=chunk)
    if p.capacity >= 2 ** 31 - MAX_CHUNK or outer >= 2 ** 31:
        raise ValueError("decode_attention: capacity must fit int32")
    ws = workspace(idx, stream, b, kvh, p, g, d)
    c = DecodePlan(*st, *cst, ws.data_ptr(), b, kvh, g, d, slots, width,
                   outer, code, p.chunk, p.n_split, vw, int(p.wide),
                   1.0 / math.sqrt(d))
    return c, ctypes.addressof(c)


def decode_attention(q, k, v, valid_len, *, layout: str = "bskd"):
    """q: (B, H, D); k, v: (B, S, KV, D) ('bskd') or (B, KV, S, D)
    ('bksd') in fp32 or bf16; valid_len: int or per-lane (B,), >= 1.
    Returns (B, H, D) in q's dtype."""
    if q.is_cpu:
        return ref.decode_attention_ref(q, k, v, valid_len, layout=layout)
    return launch(RING, q, k, v, valid_len, layout=layout)


def decode_attention_q8(q, k, v, k_scale, v_scale, valid_len, *,
                        layout: str = "bskd"):
    """Int8 K/V with one fp32 scale per (lane, head, slot): scales
    (B, S, KV) ('bskd') or (B, KV, S) ('bksd')."""
    if q.is_cpu:
        return ref.decode_attention_q8_ref(q, k, v, k_scale, v_scale,
                                           valid_len, layout=layout)
    return launch(RING_Q8, q, k, v, valid_len, layout=layout,
                  scales=(k_scale, v_scale))


def decode_attention_paged(q, k, v, page_table, valid_len, *,
                           layout: str = "bskd"):
    """Page pools k, v: (P, ps, KV, D) ('bskd') or (P, KV, ps, D)
    ('bksd'); page_table (B, W): lane b's logical slot t lives at pool
    page ``page_table[b, t // ps]``, offset ``t % ps``."""
    if q.is_cpu:
        return ref.decode_attention_paged_ref(q, k, v, page_table,
                                              valid_len, layout=layout)
    return launch(PAGED, q, k, v, valid_len, layout=layout,
                  page_table=page_table)


def decode_attention_paged_q8(q, k, v, k_scale, v_scale, page_table,
                              valid_len, *, layout: str = "bskd"):
    """Paged int8 pools with per-slot fp32 scale pools (P, ps, KV) /
    (P, KV, ps), read through the same table."""
    if q.is_cpu:
        return ref.decode_attention_paged_q8_ref(
            q, k, v, k_scale, v_scale, page_table, valid_len, layout=layout)
    return launch(PAGED_Q8, q, k, v, valid_len, layout=layout,
                  scales=(k_scale, v_scale), page_table=page_table)
