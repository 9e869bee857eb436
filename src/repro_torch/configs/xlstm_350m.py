"""xlstm-350m — sLSTM + mLSTM blocks [arXiv:2405.04517].

24L d_model=1024 4H (kv=4) d_ff=0 (projections live inside the xLSTM blocks)
vocab=50304. mLSTM blocks carry a matrix memory per head (linear-attention-like,
chunkwise-parallel); sLSTM blocks are scalar-memory recurrences (lax.scan).
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    head_dim=256,
    d_ff=0,
    vocab_size=50304,
    ssm=SSMConfig(kind="xlstm", chunk=256),
    source="arXiv:2405.04517",
)
