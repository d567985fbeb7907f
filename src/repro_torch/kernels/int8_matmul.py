"""B11: int8 matrix product with per-row and per-column dequantization.

Kernel: ``csrc/int8_matmul.cu`` (replaces repro/kernels/int8_matmul.py
``int8_matmul``).  The int8 operands multiply on the int8 tensor cores
(``mma.sync`` m16n8k32) into an int32 sum and the scales apply once, in
the epilogue; its feed is the model store's ``QTensor`` (int8 weights with
an fp32 scale per output column).  A CPU tensor takes the plain version in
``repro_torch.kernels.ref``; a CUDA tensor launches the kernel or raises.

The int32 sum is exact, so the kernel equals its plain version bit for
bit, up to K = 133,144: from K = 133,145 on, 127 * 127 * K can pass
2^31 - 1 and the sum wraps, as the TPU kernel's (and XLA's) does.

:func:`plan` picks the tile and the split of K from (M, N, K) and the SM
count, once per shape.  A split sum goes through an int32 workspace and a
ticket counter per output tile, kept per (device, stream) and left at 0
by every launch; int32 addition is order-free, so a split result is
bit-equal to an unsplit one.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels._build import CudaKernel, _raw_stream_fn, sm_count
from repro_torch.kernels.ref import int8_matmul_ref

KERNEL = CudaKernel("dlk_int8_matmul",
                    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6)

_INT_MAX = 2 ** 31 - 1
_MAX_GRID_Y = 65535
BK = 64                           # k a stage
TILES = ((16, 64), (64, 64))      # (BM, BN) of the kernel's tile codes 0, 1


class Plan(NamedTuple):
    """One call's geometry: the tile code and its (bm, bn), K split in
    ``splits`` ranges of ``per`` 64-deep stages, the grid and the output
    tiles (ticket counters)."""
    tile: int
    bm: int
    bn: int
    splits: int
    per: int
    grid: tuple
    tiles: int


@functools.lru_cache(maxsize=256)
def plan(m: int, n: int, k: int, sms: int) -> Plan:
    """16 x 64 tiles at M <= 16, 64 x 64 otherwise.  Where the tiles fill
    less than half the card, K is split so that (tiles x splits) reaches
    one CTA an SM, each split a whole number of 64-deep stages and none
    empty."""
    tile = 0 if m <= 16 else 1
    bm, bn = TILES[tile]
    tiles = -(-m // bm) * -(-n // bn)
    ktiles = -(-k // BK)
    splits = 1 if 2 * tiles >= sms else -(-sms // tiles)
    splits = max(1, min(splits, ktiles))
    per = -(-ktiles // splits) if ktiles else 0
    if per:
        splits = -(-ktiles // per)
    return Plan(tile, bm, bn, splits, per,
                (-(-n // bn), -(-m // bm), splits), tiles)


def vector_route(a_q: torch.Tensor, b_q: torch.Tensor) -> int:
    """The kernel's ``vec`` bits: 1 when A's rows take 16-byte copies (K a
    multiple of 16 and A's base on 16 bytes), 2 when B's do (N a multiple
    of 16, B's base on 16 bytes); byte loads otherwise."""
    k, n = b_q.shape
    return (int(k % 16 == 0 and a_q.data_ptr() % 16 == 0)
            | 2 * int(n % 16 == 0 and b_q.data_ptr() % 16 == 0))


_workspaces = {}


def _workspace(dev: torch.device, stream: int, cells: int, tiles: int):
    """(sums, tickets) int32 for split launches on ``stream``, zeroed when
    made and grown when too small; every launch leaves them at 0."""
    key = (dev.index, stream)
    ws = _workspaces.get(key)
    if ws is None or ws[0].numel() < cells or ws[1].numel() < tiles:
        old = (0, 0) if ws is None else (ws[0].numel(), ws[1].numel())
        ws = _workspaces[key] = (
            torch.zeros(max(cells, old[0]), dtype=torch.int32, device=dev),
            torch.zeros(max(tiles, old[1]), dtype=torch.int32, device=dev))
    return ws


def _check(a_q, b_q, a_scale, b_scale):
    if a_q.ndim != 2 or b_q.ndim != 2 or a_q.shape[1] != b_q.shape[0]:
        raise ValueError(f"int8_matmul: shapes {tuple(a_q.shape)} @ "
                         f"{tuple(b_q.shape)}")
    m, k = a_q.shape
    n = b_q.shape[1]
    if a_q.dtype != torch.int8 or b_q.dtype != torch.int8:
        raise TypeError(f"int8_matmul: operands must be int8, got "
                        f"{a_q.dtype} and {b_q.dtype}")
    if a_scale.dtype != torch.float32 or b_scale.dtype != torch.float32:
        raise TypeError(f"int8_matmul: scales must be float32, got "
                        f"{a_scale.dtype} and {b_scale.dtype}")
    if tuple(a_scale.shape) != (m,) or tuple(b_scale.shape) != (n,):
        raise ValueError(f"int8_matmul: scales {tuple(a_scale.shape)} and "
                         f"{tuple(b_scale.shape)} for M={m}, N={n}")
    return m, n, k


def int8_matmul(a_q: torch.Tensor, b_q: torch.Tensor, a_scale: torch.Tensor,
                b_scale: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 -> (M, N) fp32, scaled by a_scale (M,)
    and b_scale (N,), both fp32."""
    if a_q.device.type == "cpu":
        _check(a_q, b_q, a_scale, b_scale)
        return int8_matmul_ref(a_q, b_q, a_scale, b_scale)
    return launch(a_q, b_q, a_scale, b_scale)


def launch(a_q, b_q, a_scale, b_scale) -> torch.Tensor:
    """B11 on the card."""
    m, n, k = _check(a_q, b_q, a_scale, b_scale)
    dev = a_q.device
    tensors = (a_q, b_q, a_scale, b_scale)
    if any(t.device.type != "cuda" or t.device != dev for t in tensors):
        raise ValueError(f"int8_matmul: tensors must share one CUDA device, "
                         f"got {[str(t.device) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("int8_matmul: operands and scales must be "
                         "row-major contiguous")
    index = a_q.get_device()
    p = plan(m, n, k, sm_count(index)) if m and n else None
    if max(m, n, k) > _INT_MAX or (p and p.grid[1] > _MAX_GRID_Y) \
            or (p and p.splits > 1 and m * n > _INT_MAX):
        raise ValueError(f"int8_matmul: M={m}, N={n}, K={k} out of range")
    out = torch.empty((m, n), device=dev, dtype=torch.float32)
    if p is None:
        return out
    stream = _raw_stream_fn()(index)
    ws = tickets = None
    if p.splits > 1:
        sums, counters = _workspace(dev, stream, m * n, p.tiles)
        ws, tickets = sums.data_ptr(), counters.data_ptr()
    KERNEL.launch_on(stream, a_q.data_ptr(), b_q.data_ptr(),
                     a_scale.data_ptr(), b_scale.data_ptr(), out.data_ptr(),
                     ws, tickets, m, n, k, p.tile, p.splits,
                     vector_route(a_q, b_q))
    return out


def split_k_emulation(a_q, b_q, a_scale, b_scale, splits: int):
    """The kernel's split sum on the CPU: K in ``splits`` ranges of whole
    64-deep stages (as :func:`plan` deals them), each range's exact int32
    product, the partials added in int32 (wrapping, so in any order), then
    the epilogue: float(sum) * a_scale[m], then * b_scale[n], in fp32."""
    k = a_q.shape[1]
    per = BK * max(1, -(-(-(-k // BK)) // splits))
    acc = torch.zeros(a_q.shape[0], b_q.shape[1], dtype=torch.int32)
    for k0 in range(0, k, per):
        acc += a_q[:, k0:k0 + per].to(torch.int32) @ \
            b_q[k0:k0 + per].to(torch.int32)
    return acc.float() * a_scale.float()[:, None] * b_scale.float()[None, :]
