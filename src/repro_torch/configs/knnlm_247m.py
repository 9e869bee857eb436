"""knnlm-247m — the paper's KNN-LM base model (Khandelwal et al. 2019).

16-layer decoder-only transformer, 247M trainable parameters (d_model=1024,
16 heads, d_ff=4096), used for the §5.3 KNN-LM serving experiments.
This is the paper's own model, included beyond the 10 assigned archs.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="knnlm-247m",
    family="dense",
    num_layers=16,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=50304,
    source="arXiv:1911.00172",
)
