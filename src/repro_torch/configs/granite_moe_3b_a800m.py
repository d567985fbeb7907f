"""Granite-MoE 3B-A800M — fine-grained 40-expert top-8 MoE.

[hf:ibm-granite/granite-3.0-1b-a400m-base family card] 32 layers,
d_model 1536, 24 heads (GQA kv=8), expert d_ff 512, 40 experts top-8,
vocab 49155.
"""
from repro_torch.configs.base import ArchConfig, register


@register("granite-moe-3b-a800m")
def config() -> ArchConfig:
    return ArchConfig(
        name="granite-moe-3b-a800m",
        family="moe",
        num_layers=32,
        d_model=1536,
        num_heads=24,
        num_kv_heads=8,
        head_dim=64,
        d_ff=512,                # per-expert FFN width (fine-grained)
        num_experts=40,
        experts_per_token=8,
        vocab_size=49155,
        tie_embeddings=True,
        sliding_window=8192,
        source="hf:ibm-granite/granite-3.0-3b-a800m-base (family card)",
    )
