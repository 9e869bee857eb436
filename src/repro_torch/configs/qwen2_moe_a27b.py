"""qwen2-moe-a2.7b — 4 shared + 60 routed top-4 [hf:Qwen/Qwen1.5-MoE-A2.7B].

24L d_model=2048 16H (kv=16) expert d_ff=1408 vocab=151936, MoE 60e top-4.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=151936,
    qkv_bias=True,
    moe=MoEConfig(num_experts=60, top_k=4, d_expert=1408, num_shared_experts=4),
    moe_layer_rule="all",
    source="hf:Qwen/Qwen1.5-MoE-A2.7B",
)
