"""Qwen3-0.6B — small dense decoder with GQA and qk-norm.

[hf:Qwen/Qwen3-8B family] 28 layers, d_model 1024, 16 heads (GQA kv=8),
d_ff 3072, vocab 151936, tied embeddings.
"""
from repro_torch.configs.base import ArchConfig, register


@register("qwen3-0.6b")
def config() -> ArchConfig:
    return ArchConfig(
        name="qwen3-0.6b",
        family="dense",
        num_layers=28,
        d_model=1024,
        num_heads=16,
        num_kv_heads=8,
        head_dim=64,
        qk_norm=True,
        d_ff=3072,
        vocab_size=151936,
        tie_embeddings=True,
        rope_theta=1_000_000.0,
        sliding_window=8192,
        source="hf:Qwen/Qwen3-0.6B (Qwen3 family card)",
    )
