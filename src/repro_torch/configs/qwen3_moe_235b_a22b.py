"""Qwen3-MoE 235B-A22B — 128-expert top-8 mixture of experts.

[hf:Qwen/Qwen3-30B-A3B family card] 94 layers, d_model 4096, 64 heads
(GQA kv=4), expert d_ff 1536, 128 experts top-8, vocab 151936.
~235B total / ~22B active parameters.  It does not fit one card at full
width; the port runs it at the reduced size.
"""
from repro_torch.configs.base import ArchConfig, register


@register("qwen3-moe-235b-a22b")
def config() -> ArchConfig:
    return ArchConfig(
        name="qwen3-moe-235b-a22b",
        family="moe",
        num_layers=94,
        d_model=4096,
        num_heads=64,
        num_kv_heads=4,
        head_dim=64,
        qk_norm=True,
        d_ff=1536,               # per-expert FFN width
        num_experts=128,
        experts_per_token=8,
        vocab_size=151936,
        rope_theta=1_000_000.0,
        sliding_window=8192,
        source="hf:Qwen/Qwen3-235B-A22B (via Qwen3-30B-A3B card)",
    )
