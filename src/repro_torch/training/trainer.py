"""Train and eval steps (the reference's ``repro.training.trainer``): the LM
loss, its gradients, and the AdamW update.

The train step's forward pass takes the differentiable attention route
(``Model.forward(differentiable=True)``: the reference's plain / blockwise
attention in PyTorch), since the attention kernels have no backward; the
eval step runs under ``torch.no_grad()`` on the kernel route (B3 on the
card). Gradients come from ``torch.autograd.grad`` with respect to the
parameter tensors; the caller's tensors are neither marked nor written.

A batch is a dict of ``tokens`` and ``labels`` (B, S) and, per family,
``frames`` (B, F, d) or ``patches`` (B, P, d): numpy arrays (as the data
sources yield them) or tensors; :func:`to_device` moves them.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.mesh_ops import BATCH, shard
from repro_torch.distributed.sharding import Spec
from repro_torch.models.model import Model, build_model
from repro_torch.training.optimizer import (AdamWConfig, AdamWState, adamw_update,
                                            decay_mask, init_adamw)
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def to_device(batch: dict, device) -> dict:
    """Tokens and labels as int64 tensors, frames and patches as fp32, on
    ``device``."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(np.asarray(v)) if not isinstance(v, torch.Tensor) else v
        out[k] = t.to(device=device, dtype=torch.long if k in ("tokens", "labels")
                      else torch.float32)
    return out


def lm_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Next-token cross entropy in fp32; labels < 0 are masked (e.g. an
    image prefix)."""
    mask = (labels >= 0).float()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, labels.clamp(min=0).long()[..., None])[..., 0]
    return torch.sum(nll * mask) / torch.clamp(mask.sum(), min=1.0)


def make_loss_fn(model: Model, *, window: int = 0, remat: bool = False,
                 differentiable: bool = True):
    """loss_fn(params, batch) -> (loss + aux, {"loss", "aux"}). A VLM's
    labels are padded with -1 over its patch positions; position t predicts
    token t + 1."""
    def loss_fn(params, batch):
        extra = {k: v for k, v in batch.items() if k in ("frames", "patches")} or None
        logits, aux = model.forward(params, batch["tokens"], extra=extra, window=window,
                                    remat=remat, differentiable=differentiable)
        labels = batch["labels"]
        S = logits.shape[1]
        if labels.shape[1] < S:                # image prefix positions carry no loss
            pad = labels.new_full((labels.shape[0], S - labels.shape[1]), -1)
            labels = torch.cat([pad, labels], dim=1)
        loss = lm_loss(logits[:, :-1], labels[:, 1:])
        return loss + aux, {"loss": loss, "aux": aux}

    return loss_fn


def value_and_grad(loss_fn, params, batch):
    """(total, parts, grads): grads a tree like params (zeros for a leaf
    the loss does not reach)."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    total, parts = loss_fn(tree_unflatten(params, leaves), batch)
    grads = torch.autograd.grad(total, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    return (total.detach(), {k: v.detach() for k, v in parts.items()},
            tree_unflatten(params, grads))


def microbatches(batch: dict, n: int) -> list:
    """The ``n`` microbatches of ``batch``: microbatch i holds rows i * B / n
    .. (i + 1) * B / n of every leaf, as the reference's reshape cuts them.
    On a mesh each leaf is first gathered whole (DTensor cannot cut a batch
    dim split over the mesh into microbatches) and each microbatch is split
    over the batch axes again (``mesh_ops.shard``)."""
    out = [{} for _ in range(n)]
    for k, v in batch.items():
        if isinstance(v, DTensor):
            v = v.redistribute(v.device_mesh, [Replicate()] * v.device_mesh.ndim)
        v = v.reshape((n, v.shape[0] // n) + v.shape[1:])
        for i in range(n):
            out[i][k] = shard(v[i], Spec(BATCH, *([None] * (v.ndim - 2))))
    return out


def make_train_step(model: Model, opt_cfg: AdamWConfig, *, window: int = 0,
                    remat: bool = False, num_microbatches: int = 1):
    """train_step(params, opt_state, batch) -> (params, opt_state, metrics):
    metrics {"loss", "aux", "total", "grad_norm", "lr"} as 0-d tensors.
    ``num_microbatches`` > 1 splits the batch along its first axis and
    accumulates fp32 gradients, divided by their count, as the reference's
    scan does; loss, aux and total are then the microbatches' means."""
    loss_fn = make_loss_fn(model, window=window, remat=remat)
    decay = {}

    def train_step(params, opt_state: AdamWState, batch):
        if not decay:
            decay["mask"] = decay_mask(model.cfg, params)
        n = num_microbatches
        if n <= 1:
            total, parts, grads = value_and_grad(loss_fn, params, batch)
        else:
            grads, totals, part_list = None, [], []
            for mb in microbatches(batch, n):
                t, p, g = value_and_grad(loss_fn, params, mb)
                g = tree_map(lambda x: x.float(), g)
                grads = g if grads is None else tree_map(torch.add, grads, g)
                totals.append(t)
                part_list.append(p)
            grads = tree_map(lambda g: g / n, grads)
            total = torch.stack(totals).mean()
            parts = {k: torch.stack([p[k] for p in part_list]).mean() for k in part_list[0]}
        params, opt_state, om = adamw_update(opt_cfg, grads, opt_state, params,
                                             decay["mask"])
        return params, opt_state, dict(parts, total=total, **om)

    return train_step


def make_eval_step(model: Model):
    """eval_step(params, batch) -> {"loss", "aux", "total"}, under
    ``torch.no_grad()`` on the kernel route."""
    loss_fn = make_loss_fn(model, differentiable=False)

    def eval_step(params, batch):
        with torch.no_grad():
            total, parts = loss_fn(params, batch)
        return dict(parts, total=total)

    return eval_step


def init_train(cfg: ModelConfig, generator: torch.Generator, dtype=torch.float32):
    """(model, params drawn from ``generator`` on its device, AdamW state)."""
    model = build_model(cfg)
    params = model.init(generator, dtype)
    return model, params, init_adamw(params)
