"""jamba-v0.1-52b — Mamba+attention 1:7 interleave, MoE 16e top-2 [arXiv:2403.19887].

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536. Each period of 8 layers has
one attention layer (index 4, per the paper's figure); MoE replaces the FFN on every
second layer (moe_layer_rule="every_2").
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig

_PERIOD = ("mamba", "mamba", "mamba", "mamba", "attn", "mamba", "mamba", "mamba")

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    moe=MoEConfig(num_experts=16, top_k=2, d_expert=14336),
    moe_layer_rule="every_2",
    ssm=SSMConfig(kind="mamba", d_state=16, d_conv=4, expand=2, chunk=256),
    block_pattern=_PERIOD,
    source="arXiv:2403.19887",
)
