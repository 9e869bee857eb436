"""qwen3-4b — dense GQA with qk-norm [hf:Qwen/Qwen3-4B].

36L d_model=2560 32H (GQA kv=8) d_ff=9728 vocab=151936. Qwen3 uses head_dim=128
(decoupled from d_model/num_heads) and RMS qk-norm on per-head q/k.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b",
    family="dense",
    num_layers=36,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=9728,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen3-8B",
)
