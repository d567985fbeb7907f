"""Whisper-medium transformer backbone (encoder-decoder, audio).

[arXiv:2212.04356] Radford et al., "Robust Speech Recognition via
Large-Scale Weak Supervision".  24 encoder + 24 decoder layers,
d_model 1024, 16 heads (MHA: kv=16), d_ff 4096, vocab 51865.
The mel-spectrogram + conv frontend is a stub, as in the JAX package:
the model consumes precomputed (B, 1500, 1024) frame embeddings.
"""
from repro_torch.configs.base import ArchConfig, register


@register("whisper-medium")
def config() -> ArchConfig:
    return ArchConfig(
        name="whisper-medium",
        family="audio",
        num_layers=24,           # decoder layers
        encoder_layers=24,
        encoder_seq=1500,        # 30 s of audio at 50 Hz after conv stride
        d_model=1024,
        num_heads=16,
        num_kv_heads=16,
        head_dim=64,
        d_ff=4096,
        vocab_size=51865,
        sliding_window=8192,     # long_500k windowed-decode variant
        source="arXiv:2212.04356 (Whisper medium)",
    )
