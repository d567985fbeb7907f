"""B3: max / average pooling — the paper's pooling shader on Hopper.

Kernel: ``csrc/pool.cu`` (replaces repro/kernels/pool.py ``pool2d``).  Two
routes, both bit-equal to the plain version: a plane reduction (one warp a
plane) for one output per plane without padding, NIN's global pool, and a
windowed kernel (one thread an output, in CTAs shaped as the output tile)
for every other shape.  :func:`plan` validates a call's geometry and picks
the route, grid and block once per (shape, mode, kernel, stride, pad); the
wrapper keeps the result, so a repeated call does one dict lookup, one
check of dtype, device and contiguity, the output's allocation and the C
call with the plan's address.  A CPU tensor takes the plain version in
``repro_torch.kernels.ref``; a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.kernels._build import CudaKernel, check_cuda_f32, sm_count
from repro_torch.kernels.ref import pool2d_ref

KERNEL = CudaKernel("dlk_pool2d_f32", [ctypes.c_void_p] * 3)

THREADS = 256          # threads a windowed CTA aims at (one an output)
TILE_OUTPUTS = 1024    # most outputs, and so threads, of a windowed CTA
MAX_PLANES = 64        # most planes of a windowed CTA: its block's z
PLANE_WARPS = 4        # most warps (planes) of a plane-reduction CTA
PLANE_CHUNK = 512      # floats a warp stages at once for the average


class PoolPlan(ctypes.Structure):
    """One call's geometry and launch configuration, as the entry point
    reads it (``struct DlkPoolPlan`` in ``csrc/pool.cu``, field for
    field)."""
    _fields_ = [(name, ctypes.c_int) for name in (
        "bc", "h", "w", "oh", "ow", "kernel", "stride", "pad", "is_max",
        "route", "grid", "block", "smem", "planes", "band_rows", "band_cols",
        "row_bands", "col_bands")]


ROUTE_PLANE, ROUTE_WINDOW = 0, 1
_F32 = torch.float32
# (shape, mode, kernel, stride, pad) -> (plan, its address, output shape)
_PLANS: Dict[tuple, Tuple[PoolPlan, int, Tuple[int, ...]]] = {}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _round4(n: int) -> int:
    return _cdiv(n, 4) * 4


def geometry(shape, mode: str, kernel: int, stride: int, pad: int
             ) -> Tuple[int, int]:
    """Validate a call from its metadata; return (OH, OW)."""
    if mode not in ("max", "avg"):
        raise ValueError(f"unknown pool mode {mode!r}")
    if len(shape) != 4:
        raise ValueError(f"pool2d: expected (B, C, H, W), got {tuple(shape)}")
    h, w = shape[2], shape[3]
    if kernel <= 0 or stride <= 0 or pad < 0:
        raise ValueError(f"pool2d: window {kernel}/{stride}/{pad} on {h}x{w}")
    oh = (h + 2 * pad - kernel) // stride + 1
    ow = (w + 2 * pad - kernel) // stride + 1
    if oh <= 0 or ow <= 0:
        raise ValueError(f"pool2d: window {kernel}/{stride}/{pad} on {h}x{w}")
    return oh, ow


def plan(shape, mode: str, kernel: int, stride: int, pad: int,
         sms: int) -> PoolPlan:
    """The route and launch configuration of a pool over ``shape`` on a
    card of ``sms`` SMs.

    Plane reduction when each plane has one output and no padding: one
    warp a plane, up to PLANE_WARPS a CTA but never fewer CTAs than SMs
    where there are as many planes.  Otherwise windowed: a CTA is a
    (columns, rows, planes) block of threads, one an output, over whole
    output rows and planes (at most TILE_OUTPUTS outputs of a plane: the
    rows are halved until they fit), as many planes as fill THREADS
    threads, halved while the CTAs are fewer than the SMs."""
    oh, ow = geometry(shape, mode, kernel, stride, pad)
    b, c, h, w = shape
    bc = b * c
    p = PoolPlan(bc=bc, h=h, w=w, oh=oh, ow=ow, kernel=kernel, stride=stride,
                 pad=pad, is_max=int(mode == "max"))
    if oh == 1 and ow == 1 and pad == 0:
        warps = max(1, min(PLANE_WARPS, bc // sms))
        p.route, p.grid, p.block = ROUTE_PLANE, _cdiv(bc, warps), 32 * warps
        p.smem = 0 if mode == "max" else \
            4 * warps * min(PLANE_CHUNK, _round4(kernel * kernel))
        return p

    cols = min(ow, TILE_OUTPUTS)
    rows = oh
    while rows * cols > TILE_OUTPUTS:
        rows = _cdiv(rows, 2)
    planes = max(1, min(bc, MAX_PLANES, THREADS // (rows * cols)))

    def ctas():
        return _cdiv(bc, planes) * _cdiv(oh, rows) * _cdiv(ow, cols)
    while ctas() < sms and planes > 1:
        planes = _cdiv(planes, 2)
    p.route, p.grid, p.block = ROUTE_WINDOW, ctas(), planes * rows * cols
    p.planes, p.band_rows, p.band_cols = planes, rows, cols
    p.row_bands, p.col_bands = _cdiv(oh, rows), _cdiv(ow, cols)
    return p


def cached_plan(shape, mode: str, kernel: int, stride: int, pad: int,
                sms: int) -> Tuple[PoolPlan, int, Tuple[int, ...]]:
    """(plan, its address, output shape) for a call, made once per (shape,
    mode, kernel, stride, pad) with the SM count of the card it first ran
    on, and kept for the life of the process."""
    key = (tuple(shape), mode, kernel, stride, pad)
    entry = _PLANS.get(key)
    if entry is None:
        p = plan(shape, mode, kernel, stride, pad, sms)
        entry = _PLANS[key] = (p, ctypes.addressof(p),
                               (shape[0], shape[1], p.oh, p.ow))
    return entry


def pool2d(x: torch.Tensor, *, mode: str = "max", kernel: int = 2,
           stride: int = 2, pad: int = 0) -> torch.Tensor:
    """x: (B, C, H, W) -> (B, C, OH, OW); avg excludes padding (Caffe)."""
    entry = _PLANS.get((x.shape, mode, kernel, stride, pad))
    if entry is None or not x.is_cuda or x.dtype is not _F32 \
            or not x.is_contiguous():
        return _pool2d_checked(x, mode, kernel, stride, pad)
    out = x.new_empty(entry[2])
    KERNEL.launch(x.get_device(), x.data_ptr(), out.data_ptr(), entry[1])
    return out


def _pool2d_checked(x, mode, kernel, stride, pad):
    """The first call of a shape, a CPU tensor, or a call to refuse."""
    oh, ow = geometry(x.shape, mode, kernel, stride, pad)
    if x.is_cpu:
        return pool2d_ref(x, mode=mode, kernel=kernel, stride=stride, pad=pad)
    dev = check_cuda_f32("pool2d", x)
    if not x.is_contiguous():
        raise ValueError("pool2d: input must be contiguous")
    b, c = x.shape[:2]
    out = x.new_empty((b, c, oh, ow))
    if b and c:
        _, addr, _ = cached_plan(x.shape, mode, kernel, stride, pad,
                                 sm_count(dev))
        KERNEL.launch(dev, x.data_ptr(), out.data_ptr(), addr)
    return out
