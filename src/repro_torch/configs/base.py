"""Architecture configuration registry (the port of ``repro.configs.base``).

The port keeps its own copy of the config schema so that it imports
nothing of the JAX package.  The fields are the JAX package's, one for
one, so a spec that either package publishes (``dataclasses.asdict`` of
the config) loads in the other.  Registered here: the two CNN configs of
the paper's inference path, the two dense transformers of the serving
path, RWKV-6 Finch 3B, the two MoE decoders (Granite-MoE 3B-A800M,
Qwen3-MoE 235B-A22B), the Griffin hybrid RecurrentGemma-9B and the
encoder-decoder Whisper-medium.
``reduced()`` derives the CPU test variant from the same config.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, Dict


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm | cnn
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // num_heads
    qk_norm: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # --- recurrent (ssm / hybrid) ---
    rwkv_head_dim: int = 64        # rwkv6 head size
    lru_width: int = 0             # rg-lru state width (0 -> d_model)
    conv_width: int = 4            # temporal conv in recurrent block
    attn_period: int = 0           # hybrid: every `attn_period`-th layer is attn
    local_window: int = 0          # local attention window (hybrid)
    # --- encoder-decoder (audio) ---
    encoder_layers: int = 0
    encoder_seq: int = 0           # precomputed frame embeddings length
    # --- long-context policy ---
    sliding_window: int = 0        # >0: windowed attention variant available
    # --- misc ---
    dtype: str = "bfloat16"
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.resolved_head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.resolved_head_dim

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    def param_count(self) -> int:
        """Analytic parameter count (matches init_params)."""
        from repro_torch.models import param_count
        return param_count(self)

    def active_param_count(self) -> int:
        from repro_torch.models import param_count
        return param_count(self, active_only=True)


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


_REGISTRY: Dict[str, Callable[[], ArchConfig]] = {}


def register(name: str):
    def deco(fn: Callable[[], ArchConfig]):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_config(name: str) -> ArchConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_configs():
    _ensure_loaded()
    return sorted(_REGISTRY)


def _ensure_loaded():
    # import every config module so its @register runs
    from repro_torch.configs import (  # noqa: F401
        chameleon_34b, granite_moe_3b_a800m, lenet_mnist, llama3_8b,
        nin_cifar10, qwen3_0_6b, qwen3_8b, qwen3_moe_235b_a22b,
        recurrentgemma_9b, rwkv6_3b, tinyllama_1_1b, whisper_medium)


def reduced(cfg: ArchConfig) -> ArchConfig:
    """Smoke-test variant: same family/code path, tiny dims (<=2 layers,
    d_model<=256, head_dim 32, <=4 experts), GQA ratio and qk_norm kept.
    The JAX package's rule, unchanged, so both packages reduce a config
    to the same shapes."""
    d_model = min(cfg.d_model, 256)
    head_dim = 32
    num_heads = max(2, min(cfg.num_heads, d_model // head_dim))
    ratio = max(1, cfg.num_heads // max(1, cfg.num_kv_heads))
    num_kv_heads = max(1, num_heads // ratio)
    num_layers = min(cfg.num_layers, 2 if cfg.attn_period == 0 else 3)
    return replace(
        cfg,
        num_layers=num_layers,
        d_model=d_model,
        num_heads=num_heads,
        num_kv_heads=num_kv_heads,
        head_dim=head_dim,
        d_ff=min(cfg.d_ff, 512 if not cfg.is_moe else 128),
        vocab_size=min(cfg.vocab_size, 1024),
        num_experts=min(cfg.num_experts, 4) if cfg.is_moe else 0,
        experts_per_token=min(cfg.experts_per_token, 2) if cfg.is_moe else 0,
        lru_width=min(cfg.lru_width, d_model) if cfg.lru_width else 0,
        encoder_layers=min(cfg.encoder_layers, 2),
        encoder_seq=min(cfg.encoder_seq, 64),
        local_window=min(cfg.local_window, 32) if cfg.local_window else 0,
        sliding_window=min(cfg.sliding_window, 64) if cfg.sliding_window else 0,
        rwkv_head_dim=32,
        dtype="float32",
    )
