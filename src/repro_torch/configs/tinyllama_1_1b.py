"""TinyLlama-1.1B — llama2-architecture small dense model.

[arXiv:2401.02385] Zhang et al.  22 layers, d_model 2048, 32 heads
(GQA kv=4), d_ff 5632, vocab 32000.
"""
from repro_torch.configs.base import ArchConfig, register


@register("tinyllama-1.1b")
def config() -> ArchConfig:
    return ArchConfig(
        name="tinyllama-1.1b",
        family="dense",
        num_layers=22,
        d_model=2048,
        num_heads=32,
        num_kv_heads=4,
        head_dim=64,
        d_ff=5632,
        vocab_size=32000,
        sliding_window=8192,
        source="arXiv:2401.02385 (TinyLlama 1.1B)",
    )
