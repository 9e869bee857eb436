"""ralm-gpt2-medium — the paper's smallest naive-iterative-RaLM host model.

GPT2-medium geometry (24L, d_model=1024, 16H, d_ff=4096, vocab=50257) expressed in
the same decoder stack as the rest of the zoo. Included beyond the 10 assigned archs
so the serving benchmarks exercise the paper's own model class.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="ralm-gpt2-medium",
    family="dense",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=50257,
    qkv_bias=True,
    source="gpt2-medium (Radford et al., 2019)",
)
