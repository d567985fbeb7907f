"""Op registry — the single source of truth for layer-op semantics.

The port of the graph half of ``repro.core.ops``.  Each op registers an
:class:`OpSpec` declaring

  * ``shape``       — output-shape rule,
  * ``infer``       — attr resolution from the input shape (e.g. a conv
                      discovering ``in_channels``),
  * ``init``        — parameter initialization (``None`` = no params),
  * ``flops`` / ``weight_bytes`` — analytic cost model,
  * ``inplace``     — eligibility for buffer reuse in the memory planner,
  * ``references``  — names of earlier layers the op consumes (residual
                      adds; breaks the chain-only liveness assumption),
  * ``backends``    — named implementations, looked up per op at apply
                      time: ``ref`` (plain PyTorch) and ``cuda`` (the
                      hand-written kernels of ``repro_torch.kernels``),
  * ``caffe_type`` + ``to_caffe``/``from_caffe`` — the importer schema.

Backend functions have the uniform signature ``fn(x, params, attrs, ctx)``
where ``params`` is the layer's parameter dict (or ``None``) and ``ctx``
is an :class:`ApplyContext` carrying saved activations for ops with
``references``.  Shapes, costs and the Caffe schema are the JAX package's,
unchanged; ``init`` draws from a ``torch.Generator``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import conv2d_ref, pool2d_ref, softmax_ref

Attrs = Dict[str, Any]
Shape = Tuple[int, ...]


@dataclass
class ApplyContext:
    """Per-apply state passed to backend functions: activations saved for
    later reference (residual adds)."""
    saved: Dict[str, torch.Tensor] = field(default_factory=dict)


@dataclass(frozen=True)
class OpSpec:
    kind: str
    shape: Callable[[Attrs, Shape], Shape]
    backends: Dict[str, Callable] = field(default_factory=dict)
    infer: Optional[Callable[[Attrs, Shape], None]] = None
    init: Optional[Callable[[torch.Generator, Attrs],
                            Dict[str, torch.Tensor]]] = None
    flops: Optional[Callable[[Attrs, Shape, Shape], int]] = None
    weight_bytes: Optional[Callable[[Attrs, int], int]] = None
    inplace: bool = False
    references: Optional[Callable[[Attrs], List[str]]] = None
    caffe_type: str = ""
    to_caffe: Optional[Callable[[Attrs], Dict[str, Any]]] = None
    from_caffe: Optional[Callable[[Dict[str, Any]], Attrs]] = None
    # decode the compact block-spec value used in repro_torch.configs
    # (e.g. {"conv": [192, 5, 1, 2]} -> attrs); None = no attrs
    from_block: Optional[Callable[[Any], Attrs]] = None

    def backend(self, requested: Optional[str]) -> Callable:
        """Resolve a backend by name, falling back to ``ref`` when the op
        has no implementation under the requested name."""
        if requested and requested in self.backends:
            return self.backends[requested]
        return self.backends["ref"]

    def op_flops(self, attrs: Attrs, in_shape: Shape, out_shape: Shape) -> int:
        if self.flops is not None:
            return int(self.flops(attrs, in_shape, out_shape))
        return int(np.prod(out_shape))

    def op_weight_bytes(self, attrs: Attrs, elem: int) -> int:
        if self.weight_bytes is not None:
            return int(self.weight_bytes(attrs, elem))
        return 0


class OpRegistry:
    """kind -> OpSpec table with Caffe-type reverse lookup."""

    def __init__(self):
        self._ops: Dict[str, OpSpec] = {}

    def register(self, spec: OpSpec, *, overwrite: bool = False) -> OpSpec:
        if spec.kind in self._ops and not overwrite:
            raise ValueError(f"op {spec.kind!r} already registered")
        if "ref" not in spec.backends:
            raise ValueError(f"op {spec.kind!r} must declare a 'ref' backend")
        self._ops[spec.kind] = spec
        return spec

    def op(self, kind: str) -> OpSpec:
        try:
            return self._ops[kind]
        except KeyError:
            raise KeyError(f"unknown op kind {kind!r} "
                           f"(registered: {sorted(self._ops)})") from None

    def __contains__(self, kind: str) -> bool:
        return kind in self._ops

    def kinds(self) -> List[str]:
        return sorted(self._ops)

    def by_caffe_type(self, caffe_type: str) -> OpSpec:
        for spec in self._ops.values():
            if spec.caffe_type == caffe_type:
                return spec
        raise KeyError(f"unsupported Caffe layer type {caffe_type!r}")


REGISTRY = OpRegistry()


def batchnorm_ref(x, p, attrs):
    """Inference-mode batch normalization with stored statistics."""
    eps = attrs.get("eps", 1e-5)

    def bc(t):
        return t[None, :, None, None] if x.ndim == 4 else t
    inv = torch.rsqrt(bc(p["var"]) + eps)
    return (x - bc(p["mean"])) * inv * bc(p["scale"]) + bc(p["bias"])


# ---------------------------------------------------------------------------
# Shape / infer / init / cost rules
# ---------------------------------------------------------------------------


def _window_hw(h, w, k, s, p):
    return (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1


def _conv_shape(a, s):
    c, h, w = s
    oh, ow = _window_hw(h, w, a["kernel"], a["stride"], a["pad"])
    return (a["out_channels"], oh, ow)


def _pool_shape(a, s):
    c, h, w = s
    oh, ow = _window_hw(h, w, a["kernel"], a["stride"], a["pad"])
    return (c, oh, ow)


def _conv_init(gen, a):
    fan_in = a["in_channels"] * a["kernel"] ** 2
    w = torch.randn((a["out_channels"], a["in_channels"], a["kernel"],
                     a["kernel"]), generator=gen) * math.sqrt(2 / fan_in)
    return {"w": w, "b": torch.zeros((a["out_channels"],))}


def _dense_init(gen, a):
    w = torch.randn((a["in_features"], a["out_features"]), generator=gen) \
        * math.sqrt(2 / a["in_features"])
    return {"w": w, "b": torch.zeros((a["out_features"],))}


def _batchnorm_init(gen, a):
    n = a["num_features"]
    return {"scale": torch.ones((n,)), "bias": torch.zeros((n,)),
            "mean": torch.zeros((n,)), "var": torch.ones((n,))}


# ---------------------------------------------------------------------------
# Backend adapters (uniform fn(x, params, attrs, ctx) signature)
# ---------------------------------------------------------------------------


def _conv_ref_b(x, p, a, ctx):
    return conv2d_ref(x, p["w"], p["b"], stride=a["stride"], pad=a["pad"])


def _conv_cuda_b(x, p, a, ctx):
    return kops.conv2d(x, p["w"], p["b"], stride=a["stride"], pad=a["pad"])


def _pool_ref_b(x, p, a, ctx):
    return pool2d_ref(x, mode=a["mode"], kernel=a["kernel"],
                      stride=a["stride"], pad=a["pad"])


def _pool_cuda_b(x, p, a, ctx):
    return kops.pool2d(x, mode=a["mode"], kernel=a["kernel"],
                       stride=a["stride"], pad=a["pad"])


def _softmax_ref_b(x, p, a, ctx):
    return softmax_ref(x.reshape(x.shape[0], -1))


def _softmax_cuda_b(x, p, a, ctx):
    return kops.softmax(x.reshape(x.shape[0], -1))


def _dense_ref_b(x, p, a, ctx):
    return x @ p["w"] + p["b"]


def _dense_cuda_b(x, p, a, ctx):
    return kops.matmul(x, p["w"], p["b"])


def _add_b(x, p, a, ctx):
    return x + ctx.saved[a["src"]]


# ---------------------------------------------------------------------------
# Caffe interchange rules (importer schema — section 3 of the paper)
# ---------------------------------------------------------------------------

_POOL_MODES = {"MAX": "max", "AVE": "avg"}
_POOL_MODES_INV = {v: k for k, v in _POOL_MODES.items()}


def _conv_to_caffe(a):
    return {"convolution_param": {
        "num_output": a["out_channels"], "kernel_size": a["kernel"],
        "stride": a["stride"], "pad": a["pad"]}}


def _conv_from_caffe(entry):
    p = entry["convolution_param"]
    return dict(out_channels=p["num_output"], kernel=p["kernel_size"],
                stride=p.get("stride", 1), pad=p.get("pad", 0))


def _pool_to_caffe(a):
    return {"pooling_param": {
        "pool": _POOL_MODES_INV[a["mode"]], "kernel_size": a["kernel"],
        "stride": a["stride"], "pad": a["pad"]}}


def _pool_from_caffe(entry):
    p = entry["pooling_param"]
    return dict(mode=_POOL_MODES[p.get("pool", "MAX")],
                kernel=p["kernel_size"], stride=p.get("stride", 1),
                pad=p.get("pad", 0))


def _dense_to_caffe(a):
    return {"inner_product_param": {"num_output": a["out_features"]}}


def _dense_from_caffe(entry):
    return dict(out_features=entry["inner_product_param"]["num_output"])


def _bn_to_caffe(a):
    return {"batch_norm_param": {"eps": a.get("eps", 1e-5)}}


def _bn_from_caffe(entry):
    p = entry.get("batch_norm_param", {})
    return dict(eps=p.get("eps", 1e-5))


def _add_to_caffe(a):
    # Caffe expresses residual adds as an Eltwise(SUM) over two bottoms;
    # in this sequential schema the implicit bottom is the previous layer
    # and the explicit one is named here.
    return {"eltwise_param": {"operation": "SUM"}, "bottom": [a["src"]]}


def _add_from_caffe(entry):
    return dict(src=entry["bottom"][0])


# ---------------------------------------------------------------------------
# Built-in op set: the paper's Metal shader table + LeNet head + batchnorm
# and residual add
# ---------------------------------------------------------------------------


REGISTRY.register(OpSpec(
    kind="conv",
    shape=_conv_shape,
    infer=lambda a, s: a.setdefault("in_channels", s[0]),
    init=_conv_init,
    flops=lambda a, i, o: 2 * int(np.prod(o)) * a["in_channels"]
        * a["kernel"] ** 2,
    weight_bytes=lambda a, e:
        a["out_channels"] * a["in_channels"] * a["kernel"] ** 2 * e,
    backends={"ref": _conv_ref_b, "cuda": _conv_cuda_b},
    caffe_type="Convolution",
    to_caffe=_conv_to_caffe, from_caffe=_conv_from_caffe,
    from_block=lambda v: dict(zip(
        ("out_channels", "kernel", "stride", "pad"), v)),
))

REGISTRY.register(OpSpec(
    kind="pool",
    shape=_pool_shape,
    flops=lambda a, i, o: int(np.prod(o)) * a["kernel"] ** 2,
    backends={"ref": _pool_ref_b, "cuda": _pool_cuda_b},
    caffe_type="Pooling",
    to_caffe=_pool_to_caffe, from_caffe=_pool_from_caffe,
    from_block=lambda v: dict(zip(("mode", "kernel", "stride", "pad"), v)),
))

REGISTRY.register(OpSpec(
    kind="relu",
    shape=lambda a, s: s,
    inplace=True,
    backends={"ref": lambda x, p, a, ctx: torch.relu(x),
              "cuda": lambda x, p, a, ctx: kops.relu(x)},
    caffe_type="ReLU",
    to_caffe=lambda a: {}, from_caffe=lambda e: {},
))

REGISTRY.register(OpSpec(
    kind="softmax",
    shape=lambda a, s: s,
    inplace=True,
    backends={"ref": _softmax_ref_b, "cuda": _softmax_cuda_b},
    caffe_type="Softmax",
    to_caffe=lambda a: {}, from_caffe=lambda e: {},
))

REGISTRY.register(OpSpec(
    kind="flatten",
    shape=lambda a, s: (int(np.prod(s)),),
    inplace=True,
    backends={"ref": lambda x, p, a, ctx: x.reshape(x.shape[0], -1)},
    caffe_type="Flatten",
    to_caffe=lambda a: {}, from_caffe=lambda e: {},
))

REGISTRY.register(OpSpec(
    kind="dense",
    shape=lambda a, s: (a["out_features"],),
    infer=lambda a, s: a.setdefault("in_features", int(np.prod(s))),
    init=_dense_init,
    flops=lambda a, i, o: 2 * a["in_features"] * a["out_features"],
    weight_bytes=lambda a, e: a["in_features"] * a["out_features"] * e,
    backends={"ref": _dense_ref_b, "cuda": _dense_cuda_b},
    caffe_type="InnerProduct",
    to_caffe=_dense_to_caffe, from_caffe=_dense_from_caffe,
    from_block=lambda v: dict(out_features=v),
))

REGISTRY.register(OpSpec(
    kind="batchnorm",
    shape=lambda a, s: s,
    infer=lambda a, s: a.setdefault("num_features", s[0]),
    init=_batchnorm_init,
    flops=lambda a, i, o: 4 * int(np.prod(o)),
    weight_bytes=lambda a, e: 4 * a["num_features"] * e,
    inplace=True,
    backends={"ref": lambda x, p, a, ctx: batchnorm_ref(x, p, a)},
    caffe_type="BatchNorm",
    to_caffe=_bn_to_caffe, from_caffe=_bn_from_caffe,
))

REGISTRY.register(OpSpec(
    kind="add",
    shape=lambda a, s: s,
    references=lambda a: [a["src"]],
    backends={"ref": _add_b},
    caffe_type="Eltwise",
    to_caffe=_add_to_caffe, from_caffe=_add_from_caffe,
    from_block=lambda v: dict(src=v),
))


# ---------------------------------------------------------------------------
# Serving hot-path ops: not graph layers, but the same named-backend
# mechanism — call sites resolve `ref` (plain tensor ops) vs `cuda` (the
# flash-decode kernel) by name.  Backends take q (B, 1, H, D).
# ---------------------------------------------------------------------------


def _decode_attn_ref_b(q, k_cache, v_cache, valid_len, *, layout="bksd"):
    """Against a ring cache; valid_len scalar or (B,)."""
    from repro_torch.models.common import attention_decode
    return attention_decode(q, k_cache, v_cache, valid_len, layout=layout)


def _decode_attn_cuda_b(q, k_cache, v_cache, valid_len, *, layout="bksd"):
    return kops.decode_attention(q[:, 0], k_cache, v_cache, valid_len,
                                 layout=layout)[:, None]


def _decode_attn_ref_q8_b(q, k_cache, v_cache, valid_len, *, layout="bksd",
                          k_scale=None, v_scale=None):
    from repro_torch.kernels.ref import decode_attention_q8_ref
    return decode_attention_q8_ref(q[:, 0], k_cache, v_cache, k_scale,
                                   v_scale, valid_len, layout=layout)[:, None]


def _decode_attn_cuda_q8_b(q, k_cache, v_cache, valid_len, *, layout="bksd",
                           k_scale=None, v_scale=None):
    return kops.decode_attention_q8(q[:, 0], k_cache, v_cache, k_scale,
                                    v_scale, valid_len, layout=layout)[:, None]


def _decode_attn_paged_ref_b(q, k_cache, v_cache, valid_len, *,
                             layout="bksd", page_table=None):
    from repro_torch.kernels.ref import decode_attention_paged_ref
    return decode_attention_paged_ref(q[:, 0], k_cache, v_cache, page_table,
                                      valid_len, layout=layout)[:, None]


def _decode_attn_paged_cuda_b(q, k_cache, v_cache, valid_len, *,
                              layout="bksd", page_table=None):
    return kops.decode_attention_paged(q[:, 0], k_cache, v_cache, page_table,
                                       valid_len, layout=layout)[:, None]


def _decode_attn_paged_ref_q8_b(q, k_cache, v_cache, valid_len, *,
                                layout="bksd", k_scale=None, v_scale=None,
                                page_table=None):
    from repro_torch.kernels.ref import decode_attention_paged_q8_ref
    return decode_attention_paged_q8_ref(
        q[:, 0], k_cache, v_cache, k_scale, v_scale, page_table, valid_len,
        layout=layout)[:, None]


def _decode_attn_paged_cuda_q8_b(q, k_cache, v_cache, valid_len, *,
                                 layout="bksd", k_scale=None, v_scale=None,
                                 page_table=None):
    return kops.decode_attention_paged_q8(
        q[:, 0], k_cache, v_cache, k_scale, v_scale, page_table, valid_len,
        layout=layout)[:, None]


def resolve_decode_backend(name: Optional[str], quantized: bool = False,
                           paged: bool = False, device=None) -> str:
    """``None``/'auto' -> 'cuda' on a CUDA device, 'ref' elsewhere (the
    JAX package picks its Pallas kernel on a TPU the same way).

    ``quantized=True`` (int8 KV cache) maps the base names onto their q8
    twins ('ref' -> 'ref_q8', 'cuda' -> 'cuda_q8'); ``paged=True`` onto
    the paged twins ('paged_ref', 'paged_cuda'); the two compose.  A
    name the registry does not know raises: ``OpSpec.backend`` would fall
    back to 'ref' silently."""
    if name in (None, "auto"):
        name = "cuda" if torch.device(device or "cpu").type == "cuda" else "ref"
    if paged and name in ("ref", "cuda"):
        name = "paged_" + name
    if quantized and name in ("ref", "cuda", "paged_ref", "paged_cuda"):
        name = name + "_q8"
    known = REGISTRY.op("decode_attention").backends
    if name not in known:
        raise ValueError(f"unknown decode attention backend {name!r} "
                         f"(known: {sorted(known)} or 'auto')")
    return name


def decode_attn_flops(a: Attrs, in_shape: Shape = (), out_shape: Shape = ()) -> int:
    """Analytic flops of one decode-attention token: the QK and PV dots
    are each ``valid_len x head_dim`` MACs per q-head per layer, over the
    block-rounded, capacity-clamped valid length.  Attrs: ``num_heads``,
    ``head_dim``, ``layers``, ``valid_len``; optional ``block`` and
    ``capacity``."""
    return 4 * a["num_heads"] * a["head_dim"] * a["layers"] * _effective_slots(a)


def decode_kv_bytes(a: Attrs, elem: int = 0) -> int:
    """Analytic bytes one decode token streams from the KV cache:
    ``per_slot_bytes`` (K/V/scale bytes per slot, all layers) times the
    block-rounded valid length, plus ``fixed_bytes``."""
    return a["per_slot_bytes"] * _effective_slots(a) + a.get("fixed_bytes", 0)


def _effective_slots(a: Attrs) -> int:
    """Block-rounded, capacity-clamped number of KV slots a decode step
    with ``valid_len`` tokens of context touches."""
    v = int(a["valid_len"])
    block = int(a.get("block", 1))
    if block > 1:
        v = -(-v // block) * block
    cap = a.get("capacity")
    if cap is not None:
        v = min(v, int(cap))
    return v


REGISTRY.register(OpSpec(
    kind="decode_attention",
    shape=lambda a, s: s,
    backends={"ref": _decode_attn_ref_b, "cuda": _decode_attn_cuda_b,
              "ref_q8": _decode_attn_ref_q8_b,
              "cuda_q8": _decode_attn_cuda_q8_b,
              "paged_ref": _decode_attn_paged_ref_b,
              "paged_cuda": _decode_attn_paged_cuda_b,
              "paged_ref_q8": _decode_attn_paged_ref_q8_b,
              "paged_cuda_q8": _decode_attn_paged_cuda_q8_b},
    flops=lambda a, i, o: decode_attn_flops(a, i, o),
    weight_bytes=lambda a, e: decode_kv_bytes(a, e),
))
