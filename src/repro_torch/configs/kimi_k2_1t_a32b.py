"""kimi-k2-1t-a32b — trillion-param MoE (paper-table) [arXiv:2501.kimi2].

61L d_model=7168 64H (GQA kv=8) d_ff=2048 vocab=163840, MoE 384 experts top-8.
DeepSeek-V3-lineage layout: first layer dense FFN, remaining layers routed MoE with
one always-on shared expert.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    head_dim=112,  # 7168 / 64
    d_ff=2048,
    vocab_size=163840,
    moe=MoEConfig(num_experts=384, top_k=8, d_expert=2048, num_shared_experts=1),
    moe_layer_rule="dense_first",
    source="arXiv:2501.kimi2",
)
