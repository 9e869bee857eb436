"""Step functions, their arguments as meta tensors, and the arguments' specs,
for every (architecture x input shape) pair (the reference's
``repro.launch.steps``).

``make_step(arch, shape, mesh)`` returns ``(fn, args, specs)``: ``fn(*args)``
is the pair's step (train: the AdamW train step with remat and
microbatches; prefill: ``forward(last_only=True)``; decode: one
``decode_step_stacked`` over a cache of seq_len, or of
``LONG_CONTEXT_WINDOW`` for the 500k shape), ``args`` its arguments with
every tensor on the meta device (params, AdamW state, decode state, batch;
nothing is allocated), and ``specs`` a tree of the same structure with a
:class:`~repro_torch.distributed.sharding.Spec` at each tensor
(``sharding.to_placements`` turns one into DTensor placements over
``mesh``). The decode position is a host int (spec None): ``fn`` runs on
fake tensors in the dry-run, and a position held in a tensor would need its
value on the host.

Parameters come from :func:`meta_params`: ``Model.init`` runs under
``FakeTensorMode``, which draws nothing and allocates nothing, and each leaf
is then made again as a meta tensor of its shape and dtype.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs import LONG_CONTEXT_WINDOW, get_config, get_shape
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.distributed.sharding import (batch_axes, data_specs, mesh_sizes,
                                              param_specs, state_specs)
from repro_torch.models.model import Model, build_model
from repro_torch.training.optimizer import AdamWConfig, init_adamw
from repro_torch.training.trainer import make_train_step
from repro_torch.tree import map_with_path


def _meta(t: torch.Tensor) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype, device="meta")


def meta_params(model: Model, dtype=torch.bfloat16) -> dict:
    """``model.init``'s parameter tree as meta tensors (shapes and dtypes
    only)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        fake = model.init(torch.Generator(), dtype)
    return map_with_path(lambda _, t: _meta(t), fake)


def _extra(cfg: ModelConfig, B: int, dtype) -> dict:
    ex = {}
    if cfg.family == "audio":
        ex["frames"] = torch.empty((B, cfg.encoder_frames, cfg.d_model), dtype=dtype,
                                   device="meta")
    if cfg.family == "vlm":
        ex["patches"] = torch.empty((B, cfg.vision_patches, cfg.d_model), dtype=dtype,
                                    device="meta")
    return ex


def adapt_config(cfg: ModelConfig, shape: InputShape) -> ModelConfig:
    """Shape-driven config tweaks: MoE dispatch in chunks of ~8k tokens
    (bounds the (E, C, d) buffer); the long-context window is applied
    through the decode cache width, not the config."""
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, dispatch_chunk=8192))
    return cfg


def microbatches_for(shape: InputShape, mesh) -> int:
    """Train: about one sequence per data shard per microbatch."""
    if shape.kind != "train":
        return 1
    rows_per_shard = shape.global_batch
    sizes = mesh_sizes(mesh)
    for a in batch_axes(mesh):
        rows_per_shard //= sizes[a]
    return max(1, min(shape.global_batch, rows_per_shard))


def make_step(arch: str, shape_name: str, mesh, *, dtype=torch.bfloat16,
              num_microbatches: Optional[int] = None, kv_shard: str = "window",
              fsdp: bool = True, tp: bool = True, dispatch_chunk: Optional[int] = None):
    """-> (fn, args, specs) for one pair (module docstring)."""
    shape = get_shape(shape_name)
    cfg = adapt_config(get_config(arch), shape)
    if dispatch_chunk and cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               dispatch_chunk=dispatch_chunk))
    model = build_model(cfg)
    B, S = shape.global_batch, shape.seq_len
    params = meta_params(model, dtype)
    pspec = param_specs(params, mesh, fsdp=fsdp, tp=tp)

    if shape.kind in ("train", "prefill"):
        extra = _extra(cfg, B, dtype)
        S_text = S - (cfg.vision_patches if cfg.family == "vlm" else 0)
        tokens = torch.empty((B, S_text), dtype=torch.int32, device="meta")
    if shape.kind == "train":
        batch = {"tokens": tokens, "labels": torch.empty_like(tokens), **extra}
        opt = init_adamw(params)
        nm = num_microbatches or microbatches_for(shape, mesh)
        step = make_train_step(model, AdamWConfig(), remat=True, num_microbatches=nm)
        args = (params, opt, batch)
        return step, args, (pspec, param_specs(opt, mesh, fsdp=fsdp, tp=tp),
                            data_specs(batch, mesh))

    if shape.kind == "prefill":
        def prefill_step(params, tokens, extra):
            with torch.no_grad():
                logits, _ = model.forward(params, tokens, extra=extra or None,
                                          last_only=True)
            return logits

        args = (params, tokens, extra)
        return prefill_step, args, (pspec, data_specs({"t": tokens}, mesh)["t"],
                                    data_specs(extra, mesh))

    # decode: one new token against a cache of seq_len (a ring window for 500k)
    W = LONG_CONTEXT_WINDOW if S > 100_000 else S
    state = model.init_decode_state_stacked(B, W, device="meta", dtype=dtype)
    token = torch.empty((B,), dtype=torch.int32, device="meta")

    def decode_step(params, state, token, pos):
        with torch.no_grad():
            return model.decode_step_stacked(params, state, token, pos)

    args = (params, state, token, S - 1)
    return decode_step, args, (pspec, state_specs(state, mesh, B, kv_shard=kv_shard),
                               data_specs({"t": token}, mesh)["t"], None)
