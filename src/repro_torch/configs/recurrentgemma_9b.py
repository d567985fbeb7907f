"""RecurrentGemma-9B — Griffin hybrid: RG-LRU recurrence + local attention.

[arXiv:2402.19427] De et al., "Griffin: Mixing Gated Linear Recurrences
with Local Attention for Efficient Language Models".  38 layers,
d_model 4096, 16 heads (MQA kv=1), d_ff 12288, vocab 256000.
Pattern 1:2 — every third block is local attention (window 2048), the
other two are RG-LRU recurrent blocks.
"""
from repro_torch.configs.base import ArchConfig, register


@register("recurrentgemma-9b")
def config() -> ArchConfig:
    return ArchConfig(
        name="recurrentgemma-9b",
        family="hybrid",
        num_layers=38,
        d_model=4096,
        num_heads=16,
        num_kv_heads=1,          # MQA
        head_dim=256,
        d_ff=12288,
        vocab_size=256000,
        lru_width=4096,
        conv_width=4,
        attn_period=3,           # layer i is local-attn iff i % 3 == 2
        local_window=2048,
        source="arXiv:2402.19427 (RecurrentGemma/Griffin 9B)",
    )
