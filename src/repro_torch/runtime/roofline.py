"""Roofline accountant for the serving hot path.

The port of ``repro.runtime.roofline``.  Decode is bandwidth bound: every
token streams the weights once per batched step and each lane's live KV
prefix once.  This module turns that into analytic bytes/token and
flops/token from host-visible metadata only: the cache tensors' shapes
and dtypes (never their values), the config, and the per-lane positions
the scheduler mirrors on the host.  Nothing here reads device memory, so
accounting adds no host sync.

Per-leaf classification, as in the JAX package: ring slot buffers (``k``,
``v`` and the int8 scales) cost ``per_slot_bytes x valid_len`` to read
plus one slot written per token; paged pools (``*_pages``) the same per
slot at page granularity, with the table row a fixed read; the
encoder-decoder's cross-attention caches (``xk``/``xv``) are a fixed
read per token, plus ``4 H D L S_enc`` cross-attention flops; anything
else is recurrence state, read and written every token.  The arithmetic lives
on the ``decode_attention`` op's cost hooks (``core/ops``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.ops import REGISTRY

__all__ = ["HW_PEAKS", "HWSpec", "RooflineAccountant", "roofline_terms"]

# Published peaks.  h100-sxm: NVIDIA's data sheet for the SXM part, dense
# rates (fp32 outside the tensor cores, bf16 and int8 on them), HBM3
# bandwidth and size (80 GB) and NVLink 4 (450 GB/s each way of the 900
# GB/s total), at the full 700 W power limit; the int8 rate is B11's
# compute bound.  cpu: an
# indicative host figure, for the CPU tests only (it shows the shape of
# MBU, not a measured peak).
HW_PEAKS: Dict[str, Dict[str, Any]] = {
    "h100-sxm": {"name": "h100-sxm", "peak_flops_fp32": 67e12,
                 "peak_flops_bf16": 989e12, "peak_ops_int8": 1979e12,
                 "hbm_bw": 3.35e12, "hbm_bytes": 80e9, "link_bw": 450e9},
    "cpu": {"name": "cpu-host", "peak_flops_fp32": 2.0e11,
            "peak_flops_bf16": 2.0e11, "hbm_bw": 5.0e10},
}

# torch.cuda.get_device_name() of the cards a row describes
_CARD_ROWS = {"NVIDIA H100 80GB HBM3": "h100-sxm"}


def roofline_terms(flops: float, hbm_bytes: float,
                   hw: Dict[str, float],
                   wire_bytes: float = 0.0) -> Dict[str, object]:
    """Roofline decomposition: the time lower bound of each resource and
    the binding one.  ``hw`` carries ``peak_flops`` and ``hbm_bw``, and
    ``link_bw`` for the collective term, ``wire_bytes`` over the link
    (0 where the row names no link); there is no default machine."""
    link = hw.get("link_bw")
    terms = {"compute_s": flops / hw["peak_flops"],
             "memory_s": hbm_bytes / hw["hbm_bw"],
             "collective_s": wire_bytes / link if wire_bytes and link
             else 0.0}
    bottleneck = max(terms, key=lambda k: terms[k])
    terms["bound_s"] = terms[bottleneck]
    terms["bottleneck"] = bottleneck.replace("_s", "")
    return terms


@dataclass(frozen=True)
class HWSpec:
    """Peak rates the achieved numbers are divided by."""

    name: str
    peak_flops: float
    hbm_bw: float

    @classmethod
    def detect(cls, device, dtype=torch.float32) -> "HWSpec":
        """The row for ``device`` (no default: a CUDA caller must not get
        the CPU row by omission): the CPU row on the CPU, the H100 row on
        an H100 80GB HBM3; any other card raises (pass ``hw=``).  The
        flops peak is the one of ``dtype``, the type the products run
        in."""
        device = torch.device(device)
        if device.type == "cpu":
            row = HW_PEAKS["cpu"]
        else:
            card = torch.cuda.get_device_name(device)
            if card not in _CARD_ROWS:
                raise ValueError(f"no peak rates for {card!r}: pass hw=HWSpec"
                                 "(name, peak_flops, hbm_bw)")
            row = HW_PEAKS[_CARD_ROWS[card]]
        peak = row["peak_flops_bf16"] if dtype in (torch.bfloat16,
                                                   torch.float16) \
            else row["peak_flops_fp32"]
        return cls(str(row["name"]), float(peak), float(row["hbm_bw"]))


# leaves the classifier treats as ring KV slots / their int8 scales
_RING_KV = ("k", "v")
_RING_SCALE = ("k_scale", "v_scale")
_CROSS_KV = ("xk", "xv")


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


class RooflineAccountant:
    """Analytic per-token cost model built once per scheduler from cache
    metadata; evaluated per tick with plain host arithmetic."""

    def __init__(self, cfg, cache: Dict[str, Any], params=None, *,
                 batch: int, paged: bool = False, page_size: int = 0,
                 pages_per_lane: int = 0, block: int = 1,
                 hw: Optional[HWSpec] = None):
        self.cfg = cfg
        leaves = list(_leaves(params)) if params is not None else []
        dtype = leaves[0].dtype if leaves else torch.float32
        if hw is None:
            # the peaks of the device the cache lives on
            devices = {t.device for t in _leaves(dict(cache))}
            if len(devices) != 1:
                raise ValueError("RooflineAccountant: the cache leaves must "
                                 "lie on one device (or pass hw=), got "
                                 f"{sorted(map(str, devices))}")
            hw = HWSpec.detect(devices.pop(), dtype)
        self.hw = hw
        self._spec = REGISTRY.op("decode_attention")
        heads = max(1, cfg.num_heads)
        kv = max(1, cfg.num_kv_heads)
        d = max(1, cfg.resolved_head_dim)
        groups: Dict[Tuple[int, int], int] = {}
        attn: Dict[Tuple[int, int], int] = {}   # (cap, block) -> layers
        self._fixed_bytes = 0.0     # read-only per token per lane
        self._state_bytes = 0.0     # recurrence: read+write per token
        self._cross_flops = 0
        for name, arr in dict(cache).items():
            nbytes = _nbytes(arr)
            if paged and name.endswith("_pages"):
                pool_pages = int(arr.shape[1])
                per_slot = nbytes // (pool_pages * page_size)
                key = (pages_per_lane * page_size, max(1, page_size))
                groups[key] = groups.get(key, 0) + per_slot
                if name == "k_pages":
                    attn[key] = attn.get(key, 0) + int(arr.shape[0])
            elif name == "page_table":
                self._fixed_bytes += nbytes / max(1, batch)
            elif name in _RING_KV:
                layers = int(arr.shape[0])
                slots = arr.numel() // (layers * batch * kv * d)
                key = (int(slots), max(1, block))
                groups[key] = groups.get(key, 0) + nbytes // (batch * slots)
                if name == "k":
                    attn[key] = attn.get(key, 0) + layers
            elif name in _RING_SCALE:
                layers = int(arr.shape[0])
                slots = arr.numel() // (layers * batch * kv)
                key = (int(slots), max(1, block))
                groups[key] = groups.get(key, 0) + nbytes // (batch * slots)
            elif name in _CROSS_KV:
                self._fixed_bytes += nbytes / max(1, batch)
                if name == "xk":
                    layers = int(arr.shape[0])
                    enc = arr.numel() // (layers * batch * kv * d)
                    self._cross_flops += 4 * heads * d * layers * int(enc)
            else:
                self._state_bytes += 2.0 * nbytes / max(1, batch)
        self._groups: List[Tuple[int, int, int]] = \
            [(psb, cap, blk) for (cap, blk), psb in sorted(groups.items())]
        self._attn: List[Tuple[int, int, int]] = \
            [(layers, cap, blk) for (cap, blk), layers in sorted(attn.items())]
        self._write_bytes = sum(psb for psb, _, _ in self._groups)
        self._heads, self._head_dim = heads, d
        # the batched step reads the parameters once however many lanes
        # decode
        pbytes = sum(_nbytes(x) for x in leaves)
        total_p = max(1, cfg.param_count())
        active_p = cfg.active_param_count()
        self.weight_bytes_per_step = pbytes * (active_p / total_p)
        self.linear_flops_per_token = 2 * active_p

    # -- per-token closed forms (host arithmetic only) ----------------------

    def kv_read_bytes(self, valid_len: int) -> int:
        """KV-cache bytes ONE token with ``valid_len`` context reads."""
        return sum(self._spec.op_weight_bytes(
            {"per_slot_bytes": psb, "valid_len": valid_len, "block": blk,
             "capacity": cap}, 0) for psb, cap, blk in self._groups)

    def token_bytes(self, valid_len: int) -> float:
        """Bytes one lane's token moves, less the per-step weight stream:
        KV read + one slot written + fixed reads + recurrence state."""
        return (self.kv_read_bytes(valid_len) + self._write_bytes
                + self._fixed_bytes + self._state_bytes)

    def token_flops(self, valid_len: int) -> float:
        """Flops for one lane's token: ragged attention (the op's cost
        hook), cross-attention where the family has it, and 2 flops per
        active weight."""
        flops = self._cross_flops + self.linear_flops_per_token
        for layers, cap, blk in self._attn:
            flops += self._spec.op_flops(
                {"num_heads": self._heads, "head_dim": self._head_dim,
                 "layers": layers, "valid_len": valid_len,
                 "block": blk, "capacity": cap}, (), ())
        return flops

    def step_cost(self, valid_lens: Sequence[int]) -> Tuple[float, float]:
        """(bytes, flops) of ONE batched decode step over lanes with these
        context lengths; the weight stream is charged once per step."""
        if not len(valid_lens):
            return 0.0, 0.0
        by = self.weight_bytes_per_step
        fl = 0.0
        for v in valid_lens:
            by += self.token_bytes(int(v))
            fl += self.token_flops(int(v))
        return by, fl

    # -- achieved vs roofline ----------------------------------------------

    def utilization(self, bytes_moved: float, flops: float,
                    elapsed_s: float) -> Tuple[float, float]:
        """(MBU, MFU) over ``elapsed_s`` as fractions of the peaks."""
        if elapsed_s <= 0.0:
            return 0.0, 0.0
        return (bytes_moved / elapsed_s / self.hw.hbm_bw,
                flops / elapsed_s / self.hw.peak_flops)

    def roofline_tok_per_s(self, bytes_per_token: float) -> float:
        """Tokens/s if the memory stream were the only cost."""
        if bytes_per_token <= 0.0:
            return 0.0
        return self.hw.hbm_bw / bytes_per_token

    def describe(self) -> Dict[str, Any]:
        """Static metadata for export surfaces."""
        return {
            "hw": {"name": self.hw.name, "peak_flops": self.hw.peak_flops,
                   "hbm_bw": self.hw.hbm_bw},
            "slot_groups": [
                {"per_slot_bytes": psb, "capacity": cap, "block": blk}
                for psb, cap, blk in self._groups],
            "fixed_bytes_per_token": self._fixed_bytes,
            "state_bytes_per_token": self._state_bytes,
            "write_bytes_per_token": self._write_bytes,
            "weight_bytes_per_step": self.weight_bytes_per_step,
            "linear_flops_per_token": self.linear_flops_per_token,
        }

    def bound(self, bytes_moved: float, flops: float) -> Dict[str, Any]:
        """Roofline decomposition of an accounted interval."""
        return roofline_terms(flops, bytes_moved,
                              hw={"peak_flops": self.hw.peak_flops,
                                  "hbm_bw": self.hw.hbm_bw})


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree
