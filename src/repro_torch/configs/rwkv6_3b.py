"""RWKV6 "Finch" 3B — attention-free SSM with data-dependent decay.

[arXiv:2404.05892] Peng et al., "Eagle and Finch: RWKV with Matrix-Valued
States and Dynamic Recurrence".  32 layers, d_model 2560 (40 heads of 64),
channel-mix d_ff 8960, vocab 65536.
"""
from repro_torch.configs.base import ArchConfig, register


@register("rwkv6-3b")
def config() -> ArchConfig:
    return ArchConfig(
        name="rwkv6-3b",
        family="ssm",
        num_layers=32,
        d_model=2560,
        num_heads=40,            # 2560 / 64
        num_kv_heads=40,
        head_dim=64,
        rwkv_head_dim=64,
        d_ff=8960,
        vocab_size=65536,
        tie_embeddings=False,
        source="arXiv:2404.05892 (RWKV-6 Finch 3B)",
    )
