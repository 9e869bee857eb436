"""Config registry: ``get_config(arch_id)`` + ``reduced(config)`` for smoke tests."""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import (AsyncConfig, FaultConfig, InputShape,
                                ModelConfig, MoEConfig, QueueConfig,
                                RaLMConfig, SpeculationConfig, SSMConfig)
from repro_torch.configs.shapes import LONG_CONTEXT_WINDOW, SHAPES

from repro_torch.configs import (  # noqa: E402
    command_r_plus_104b,
    jamba_v01_52b,
    kimi_k2_1t_a32b,
    knnlm_247m,
    llama32_1b,
    paligemma_3b,
    qwen15_110b,
    qwen2_moe_a27b,
    qwen3_4b,
    ralm_gpt2_medium,
    whisper_base,
    xlstm_350m,
)

_MODULES = (
    kimi_k2_1t_a32b,
    qwen15_110b,
    xlstm_350m,
    whisper_base,
    paligemma_3b,
    qwen2_moe_a27b,
    command_r_plus_104b,
    qwen3_4b,
    jamba_v01_52b,
    llama32_1b,
    knnlm_247m,
    ralm_gpt2_medium,
)

REGISTRY = {m.CONFIG.name: m.CONFIG for m in _MODULES}

# The 10 architectures assigned from the public pool (the extra two are the paper's own).
ASSIGNED_ARCHS = (
    "kimi-k2-1t-a32b",
    "qwen1.5-110b",
    "xlstm-350m",
    "whisper-base",
    "paligemma-3b",
    "qwen2-moe-a2.7b",
    "command-r-plus-104b",
    "qwen3-4b",
    "jamba-v0.1-52b",
    "llama3.2-1b",
)


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[name]


def get_shape(name: str) -> InputShape:
    return SHAPES[name]


def reduced(cfg: ModelConfig, *, layers: int = 2, d_model: int = 128,
            vocab: int = 512, experts: int = 4) -> ModelConfig:
    """Reduced same-family variant for CPU smoke tests (<=2 layers, d_model<=512,
    <=4 experts), preserving every structural feature of the full config."""
    n_heads = max(2, min(cfg.num_heads, 4))
    n_kv = max(1, min(cfg.num_kv_heads, n_heads))
    head_dim = max(16, d_model // n_heads)
    updates = dict(
        num_layers=layers,
        d_model=d_model,
        num_heads=n_heads,
        num_kv_heads=n_kv,
        head_dim=head_dim,
        d_ff=(d_model * 4 if cfg.d_ff else 0),
        vocab_size=vocab,
    )
    if cfg.moe is not None:
        updates["moe"] = dataclasses.replace(
            cfg.moe,
            num_experts=min(experts, cfg.moe.num_experts),
            top_k=min(2, cfg.moe.top_k),
            d_expert=d_model * 2,
            num_shared_experts=min(1, cfg.moe.num_shared_experts),
            dispatch_chunk=64,
        )
        # keep at least one MoE layer in 2-layer smoke models
        if cfg.moe_layer_rule in ("every_2", "dense_first"):
            updates["moe_layer_rule"] = cfg.moe_layer_rule
    if cfg.ssm is not None:
        updates["ssm"] = dataclasses.replace(cfg.ssm, chunk=32)
        if cfg.ssm.kind == "xlstm":
            # keep both block kinds in the 2-layer smoke variant
            updates["block_pattern"] = ("mlstm", "slstm")[: layers]
    if cfg.block_pattern:
        # preserve the hybrid character within 2 layers: one mamba + one attn
        updates["block_pattern"] = ("mamba", "attn")[: layers]
    if cfg.encoder_layers:
        updates["encoder_layers"] = min(2, cfg.encoder_layers)
        updates["encoder_frames"] = 64
    if cfg.vision_patches:
        updates["vision_patches"] = 16
    return dataclasses.replace(cfg, **updates)


__all__ = [
    "ASSIGNED_ARCHS",
    "AsyncConfig",
    "FaultConfig",
    "InputShape",
    "LONG_CONTEXT_WINDOW",
    "ModelConfig",
    "MoEConfig",
    "QueueConfig",
    "RaLMConfig",
    "SpeculationConfig",
    "REGISTRY",
    "SHAPES",
    "SSMConfig",
    "get_config",
    "get_shape",
    "reduced",
]
