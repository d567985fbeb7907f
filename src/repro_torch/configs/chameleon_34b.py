"""Chameleon-34B — early-fusion mixed-modal decoder (VLM).

[arXiv:2405.09818] Chameleon team, "Chameleon: Mixed-Modal Early-Fusion
Foundation Models".  48 layers, d_model 8192, 64 heads (GQA kv=8),
d_ff 22016, vocab 65536 (text + VQ image codes in one vocabulary).
The VQ-VAE image tokenizer is STUBBED per the assignment: image patches
arrive as token ids already in the shared vocab, so the backbone is a
dense decoder with qk-norm (Chameleon's QK-Norm stabilization).
"""
from repro_torch.configs.base import ArchConfig, register


@register("chameleon-34b")
def config() -> ArchConfig:
    return ArchConfig(
        name="chameleon-34b",
        family="vlm",
        num_layers=48,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        qk_norm=True,            # Chameleon uses QK-Norm for stability
        d_ff=22016,
        vocab_size=65536,
        sliding_window=8192,
        source="arXiv:2405.09818 (Chameleon 34B)",
    )
