"""paligemma-3b — SigLIP + gemma VLM backbone, vision tower STUBBED [arXiv:2407.07726].

18L d_model=2048 8H (GQA kv=1, i.e. MQA) d_ff=16384 vocab=257216. input_specs()
provides pre-projected patch embeddings (256 patches) as the sequence prefix;
the gemma-style decoder (GeGLU-ish FFN approximated by SwiGLU, RoPE) is fully real.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257216,
    vision_patches=256,
    tie_embeddings=True,
    source="arXiv:2407.07726",
)
