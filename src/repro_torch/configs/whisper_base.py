"""whisper-base — enc-dec audio backbone, conv frontend STUBBED [arXiv:2212.04356].

6L d_model=512 8H (kv=8) d_ff=2048 vocab=51865. Encoder consumes precomputed
frame embeddings (the mel+conv frontend is the assignment's allowed stub);
decoder is a standard transformer with cross-attention.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="audio",
    num_layers=6,           # decoder layers
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab_size=51865,
    encoder_layers=6,
    encoder_frames=1500,    # 30 s of audio at 50 Hz after conv stride-2
    rope_theta=0.0,         # whisper uses learned/sinusoidal positions, not RoPE
    source="arXiv:2212.04356",
)
