"""B10: the chunked RWKV-6 WKV from a zero state.

Kernel: ``csrc/rwkv6_chunk.cu`` (replaces repro/kernels/rwkv6_chunk.py
``rwkv6_chunked``, body ``_wkv_kernel``).  r, k, v are (B, T, H, N) of
one dtype, fp32 or bf16, and w is (B, T, H, N) fp32 or in r's dtype (a
bf16 RWKV-6 keeps its decay in fp32); each is read in its own dtype
(fp32 arithmetic, fp64 sums where the bar needs them); u is (H, N).  The
result is out (B, T, H, N) in r's dtype and the final state (B, H, N, N)
fp32.  Head sizes 32 and 64; T need not be a multiple
of the 16-token chunk (the kernel masks the ragged end, where the TPU
wrapper pads by a copy).

The kernel runs in two passes: one CTA a (chunk, head, batch) writes the
chunk's state-independent terms to a workspace (:func:`_records`), then
one CTA a (block of N / 2 value columns, head, batch) scans the chunks in
order (:func:`plan`).  :func:`column_emulation` repeats its arithmetic in
plain torch for the CPU tests.

A CPU tensor takes the plain version (``ref.rwkv6_chunked_ref``, the
model's ``wkv_chunked``); a CUDA tensor launches the kernel or raises; a
meta tensor takes the CUDA path's checks and allocations and launches
nothing (the dry run's memory count, ``launch.memory``).  A launch
allocates out and state, contiguous copies of strided inputs and an fp32
u where u is not one, and records over ``KEEP_BYTES`` (:func:`_records`),
all per launch; the ``KEEP_BYTES`` buffer is kept from its first use on.
There is no initial state and no backward: the model's ``wkv_named``
takes the plain version for those.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import CudaKernel, _raw_stream_fn

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_SIZES = (32, 64)
CHUNK = 16                       # tokens a chunk
GROUPS = 8                       # key-row groups of the column phase
KEEP_BYTES = 64 << 20            # records kept between launches, a stream
_P = ctypes.c_void_p
_I = ctypes.c_int

KERNEL = CudaKernel("dlk_rwkv6_chunked", [_P] * 8 + [_I] * 7)


class Plan(NamedTuple):
    """One call's geometry: the first pass's grid (chunks, H, B) of 8 N
    threads; the scan's ``mb`` = N / 2 value columns a CTA, its
    ``threads`` = 8 mb and grid (2, H, B); the workspace's bytes a record
    and in all."""
    mb: int
    threads: int
    grid: tuple
    prep_grid: tuple
    record: int
    workspace: int


def record_bytes(n: int) -> int:
    """sizeof(Rec<N>): r and k decayed (16 x N fp32 each), the chunk's
    decay (N fp32) and att . v (16 x N fp64)."""
    return 4 * (2 * CHUNK * n + n) + 8 * CHUNK * n


@functools.lru_cache(maxsize=256)
def plan(b: int, t: int, h: int, n: int) -> Plan:
    """The kernel's geometry; its column block is fixed at N / 2 (32 at N
    64), the fastest of 8, 16, 32 and 64 at both 1 x 300 and 8 x 2048 x 40
    x 64 on the H100 (PERF.md)."""
    if n not in HEAD_SIZES:
        raise ValueError(f"rwkv6_chunked: head size N {n} (the kernel takes "
                         f"{HEAD_SIZES})")
    mb = n // 2
    nc = -(-t // CHUNK)
    rec = record_bytes(n)
    return Plan(mb, GROUPS * mb, (n // mb, h, b), (nc, h, b), rec,
                b * h * nc * rec)


_kept = {}


def _records(dev: torch.device, stream: int, nbytes: int) -> torch.Tensor:
    """The records' buffer.  Up to KEEP_BYTES (1 x 1600 tokens or 5
    prompts of 300 at RWKV-6 3B's heads) it is one buffer of KEEP_BYTES
    per (device, stream), made at the first such launch and reused,
    sparing the launch an allocation (5-7 host µs); a larger call takes
    its own from the caching allocator (inside a CUDA graph capture,
    from the graph's pool), which gets it back when the launch is done.
    The kept buffer is never replaced: a captured launch holds its
    address, so a later and larger call (another prefill bucket's
    capture on the same stream) must not free it.  Graphs that hold it
    run one at a time on one stream.  Every launch writes what it reads,
    so the buffer is never cleared."""
    if nbytes > KEEP_BYTES:
        return torch.empty(nbytes, dtype=torch.uint8, device=dev)
    key = (dev.index, stream)
    ws = _kept.get(key)
    if ws is None:
        ws = _kept[key] = torch.empty(KEEP_BYTES, dtype=torch.uint8,
                                      device=dev)
    return ws


def drop_meta() -> None:
    """Forget the meta records' buffer: the next meta call makes it anew,
    as a first launch does."""
    for key in [key for key, ws in _kept.items() if ws.is_meta]:
        del _kept[key]


def dtype_refusal(r, k, v, w):
    """Why the kernel refuses these inputs' dtypes, or None.  It takes r,
    k, v of one dtype, float32 or bfloat16, and w in float32 or r's
    dtype: RWKV-6's decay is fp32 beside bf16 r, k, v in a bf16 model
    (bf16 would round a decay near 1 to 1)."""
    if r.dtype in DTYPES and k.dtype == v.dtype == r.dtype \
            and w.dtype in (torch.float32, r.dtype):
        return None
    return ("rwkv6_chunked: r, k, v of one dtype, float32 or bfloat16, and "
            f"w float32 or r's dtype, got {[x.dtype for x in (r, k, v, w)]}")


def _check(r, k, v, w, u):
    """Validate devices, dtypes and shapes from metadata; return
    (B, T, H, N) and the inputs ready for a launch (contiguous, u fp32)."""
    name = "rwkv6_chunked"
    shape = r.shape
    if r.ndim != 4 or k.shape != shape or v.shape != shape \
            or w.shape != shape:
        raise ValueError(f"{name}: r, k, v, w must share one (B, T, H, N) "
                         f"shape, got {[tuple(x.shape) for x in (r, k, v, w)]}")
    b, t, h, n = shape
    if tuple(u.shape) != (h, n):
        raise ValueError(f"{name}: u must be (H, N) = {(h, n)}, got "
                         f"{tuple(u.shape)}")
    dev = r.device
    for x in (r, k, v, w, u):
        if x.device.type not in ("cuda", "meta") or x.device != dev:
            raise ValueError(f"{name}: tensors must share one CUDA device, "
                             f"got {[str(y.device) for y in (r, k, v, w, u)]}")
    why = dtype_refusal(r, k, v, w)
    if why is not None:
        raise TypeError(why)
    if n not in HEAD_SIZES:
        raise ValueError(f"{name}: head size N {n} (the kernel takes "
                         f"{HEAD_SIZES})")
    if b < 1 or t < 1 or h < 1 or b > 65535 or h > 65535:
        raise ValueError(f"{name}: B, T, H out of range {tuple(shape)}")
    ready = [x if x.is_contiguous() else x.contiguous() for x in (r, k, v, w)]
    if u.dtype is not torch.float32 or not u.is_contiguous():
        u = u.float().contiguous()
    return (b, t, h, n), ready + [u]


def rwkv6_chunked(r, k, v, w, u):
    """r, k, v, w (B, T, H, N), u (H, N) -> (out (B, T, H, N) in r's
    dtype, state (B, H, N, N) fp32), from a zero state."""
    if r.device.type == "cpu":
        return ref.rwkv6_chunked_ref(r, k, v, w, u)
    (b, t, h, n), x = _check(r, k, v, w, u)
    out = torch.empty((b, t, h, n), dtype=r.dtype, device=r.device)
    state = torch.empty((b, h, n, n), dtype=torch.float32, device=r.device)
    return _launch(x, out, state, b, t, h, n)


def rwkv6_chunked_into(r, k, v, w, u, out, state):
    """B10 writing into the caller's contiguous ``out`` (B, T, H, N) in
    r's dtype and ``state`` (B, H, N, N) fp32: every row t < T of ``out``
    and every element of ``state``, and nothing else.  Returns them."""
    (b, t, h, n), x = _check(r, k, v, w, u)
    for what, y, shape, dtype in (("out", out, (b, t, h, n), r.dtype),
                                  ("state", state, (b, h, n, n),
                                   torch.float32)):
        if tuple(y.shape) != shape or y.dtype != dtype \
                or y.device != r.device or not y.is_contiguous():
            raise ValueError(f"rwkv6_chunked: {what} must be contiguous "
                             f"{dtype} {shape} on {r.device}, got {y.dtype} "
                             f"{tuple(y.shape)} on {y.device}")
    return _launch(x, out, state, b, t, h, n)


def _launch(x, out, state, b, t, h, n):
    r, k, v, w, u = x
    p = plan(b, t, h, n)
    stream = _raw_stream_fn()(r.get_device()) if r.is_cuda else 0
    ws = _records(r.device, stream, p.workspace)
    if r.is_meta:
        return out, state
    pr, pk, pv, pw = r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr()
    KERNEL.launch_on(stream, pr, pk, pv, pw, u.data_ptr(), out.data_ptr(),
                     state.data_ptr(), ws.data_ptr(), b, t, h, n,
                     DTYPES[r.dtype], DTYPES[w.dtype],
                     int((pr | pk | pv | pw) % 16 == 0))
    return out, state


# ---------------------------------------------------------------------------
# the kernel's arithmetic in plain torch (the CPU tests hold it to the JAX
# package and to an fp64 evaluation)
# ---------------------------------------------------------------------------

_EXP2_FLOOR = float(torch.tensor(-60.0 * math.log2(math.e),
                                 dtype=torch.float32))


def _fma32(a, b, c):
    """fp32 a * b + c rounded once (exact product in fp64, then one
    rounding of the sum to fp32; it differs from a fused multiply-add only
    where that second rounding breaks a tie)."""
    return (a.double() * b.double() + c.double()).float()


def _pair_tree(x):
    """The adjacent-pair balanced tree over the last axis (a power of 2)."""
    while x.shape[-1] > 1:
        x = x[..., 0::2] + x[..., 1::2]
    return x[..., 0]


def column_emulation(r, k, v, w, u, mb: int = 0):
    """The kernel's arithmetic order on the CPU, value columns in blocks
    of ``mb`` (the kernel's N / 2 unless given; the tests also run whole
    heads, the unsplit form, to show the split changes no bit): per
    16-token chunk,
    log2 w in fp32 (0 past T), its cumsum in fp64, split into fp32 hi + lo;
    a pair's exponent (hi_a - hi_b) + (lo_a - lo_b) in fp32, clipped to
    [-60 log2 e, 0] and taken by exp2 in fp32; att's terms (r k) fac in
    fp64, summed as an adjacent-pair tree over N; r and k decayed by fp32
    exp2 of the fp64 exponent; (r decayed) . S as 8 fp32 chains of N / 8
    key rows, the state update as 16-term fp32 chains; out = (att . v over
    even j + over odd j, in fp64) + the 8 chains' adjacent-pair tree,
    rounded once.  Returns (out in r's dtype, state fp32)."""
    b, t, h, n = r.shape
    mb = mb or n // 2
    c = CHUNK
    nc = -(-t // c)
    pad = nc * c - t
    f = [torch.nn.functional.pad(x.float(), (0, 0, 0, 0, 0, pad))
         for x in (r, k, v, w)]
    live = torch.arange(nc * c) < t
    u = u.float()
    ng = n // GROUPS
    lower = torch.tril(torch.ones(c, c, dtype=torch.bool), -1)
    eye = torch.eye(c, dtype=torch.bool)
    out = torch.empty(b, nc * c, h, n)
    s = torch.zeros(b, h, n, n)
    for ci in range(nc):
        rows = slice(ci * c, (ci + 1) * c)
        rr, kk, vv, ww = (x[:, rows].permute(0, 2, 1, 3) for x in f)  # b h c n
        lw = torch.where(live[rows][None, None, :, None],
                         torch.log2(ww.clamp(1e-26, 1.0)),
                         torch.zeros((), dtype=torch.float32))
        cum = torch.cumsum(lw.double(), 2)
        cumx = torch.cat([torch.zeros_like(cum[:, :, :1]), cum], 2)  # cum_{i-1}
        hi = cumx.float()
        lo = (cumx - hi.double()).float()
        cl = cum[:, :, -1]
        dl = torch.exp2(cl.float())
        rdec = rr * torch.exp2(cumx[:, :, :c].float())
        kdec = kk * torch.exp2((cl[:, :, None] - cum).float())
        x = ((hi[:, :, :c, None] - hi[:, :, None, 1:])
             + (lo[:, :, :c, None] - lo[:, :, None, 1:]))          # b h i j n
        fac = torch.exp2(x.clamp(_EXP2_FLOOR, 0.0))
        fac = torch.where(eye[..., None], u[None, :, None, None, :], fac)
        term = (rr[:, :, :, None].double() * kk[:, :, None].double()) \
            * fac.double()
        att = torch.where((lower | eye)[None, None], _pair_tree(term),
                          torch.zeros((), dtype=torch.float64))
        for m0 in range(0, n, mb):
            cols = slice(m0, m0 + mb)
            vb, sb = vv[..., cols], s[..., cols]                     # b h c mb
            shape = (b, h, c, sb.shape[-1])
            parts = []
            for g in range(GROUPS):
                acc = torch.zeros(shape)
                for e in range(ng):
                    key = g * ng + e
                    acc = _fma32(rdec[:, :, :, key, None],
                                 sb[:, :, key, None, :].expand(shape), acc)
                parts.append(acc)
            kv = torch.zeros(b, h, n, sb.shape[-1])
            for j in range(c):
                kv = _fma32(kdec[:, :, j, :, None].expand_as(kv),
                            vb[:, :, j, None, :].expand_as(kv), kv)
            s[..., cols] = _fma32(dl[..., None].expand_as(kv), sb, kv)
            even = torch.zeros(shape, dtype=torch.float64)
            odd = torch.zeros(shape, dtype=torch.float64)
            for j in range(0, c, 2):
                even = even + att[:, :, :, j, None] * vb[:, :, j, None, :].double()
                odd = odd + att[:, :, :, j + 1, None] \
                    * vb[:, :, j + 1, None, :].double()
            groups = _pair_tree(torch.stack([x.double() for x in parts], -1))
            a = (even + odd) + groups
            out[:, rows, :, cols] = a.float().permute(0, 2, 1, 3)
    return out[:, :t].to(r.dtype), s
