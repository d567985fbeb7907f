"""Qwen3-8B — dense decoder with GQA and qk-norm.

[hf:Qwen/Qwen3-8B] 36 layers, d_model 4096, 32 heads (GQA kv=8),
d_ff 12288, vocab 151936, per-head RMSNorm on q and k.
"""
from repro_torch.configs.base import ArchConfig, register


@register("qwen3-8b")
def config() -> ArchConfig:
    return ArchConfig(
        name="qwen3-8b",
        family="dense",
        num_layers=36,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        qk_norm=True,
        d_ff=12288,
        vocab_size=151936,
        rope_theta=1_000_000.0,
        sliding_window=8192,
        source="hf:Qwen/Qwen3-8B",
    )
