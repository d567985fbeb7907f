"""Llama-3-8B — dense decoder, GQA, 128k vocab.

[arXiv:2407.21783] Llama Team.  32 layers, d_model 4096, 32 heads
(GQA kv=8), d_ff 14336, vocab 128256.
"""
from repro_torch.configs.base import ArchConfig, register


@register("llama3-8b")
def config() -> ArchConfig:
    return ArchConfig(
        name="llama3-8b",
        family="dense",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=128256,
        rope_theta=500_000.0,
        sliding_window=8192,
        source="arXiv:2407.21783 (Llama 3 8B)",
    )
