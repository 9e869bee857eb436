"""llama3.2-1b — small llama3 [hf:meta-llama/Llama-3.2-1B].

16L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=128256, tied embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-1b",
    family="dense",
    num_layers=16,
    d_model=2048,
    num_heads=32,
    num_kv_heads=8,
    head_dim=64,
    d_ff=8192,
    vocab_size=128256,
    tie_embeddings=True,
    rope_theta=500_000.0,
    source="hf:meta-llama/Llama-3.2-1B",
)
