"""AdamW with a cosine schedule and global-norm clipping (the reference's
``repro.training.optimizer``), over the port's parameter dict.

The state is ``(step, mu, nu)``: a 0-d int32 step and fp32 first and second
moments, trees that mirror the parameters. An update builds new tensors and
never writes into the ones it was given.

Weight decay: the reference decays a leaf iff its ``ndim >= 2``, over its own
parameter tree, which stacks the layers of a repeating period for
``lax.scan`` (``models.convert``). There a norm scale or a bias of a stacked
layer is 2-D and is decayed, while the same leaf of a prefix layer, or
``final_norm``, is 1-D and is not. The port keeps its layers unstacked, so
``decay_mask`` marks a leaf for decay iff its reference counterpart has
``ndim >= 2``, and ``adamw_update`` takes that mask.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, NamedTuple

import torch

from repro_torch.models.convert import stacked_leaves
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


class AdamWState(NamedTuple):
    step: torch.Tensor          # () int32
    mu: dict
    nu: dict


def decay_mask(model_cfg, params: dict) -> dict:
    """True at each leaf the reference decays: its counterpart there has
    ndim >= 2, one more than the port's where the reference stacks it."""
    return tree_map(lambda p, s: p.ndim + int(s) >= 2, params,
                    stacked_leaves(model_cfg, params))


def cosine_schedule(cfg: AdamWConfig) -> Callable[[torch.Tensor], torch.Tensor]:
    """Linear warmup to ``lr`` over ``warmup_steps``, then a cosine down to
    ``lr * min_lr_ratio`` at ``total_steps``; fp32, as the reference's."""
    def sched(step):
        step = torch.as_tensor(step).float()
        warm = step / max(cfg.warmup_steps, 1)
        prog = torch.clamp((step - cfg.warmup_steps)
                           / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
        cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
        return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)
    return sched


def init_adamw(params) -> AdamWState:
    leaves = tree_leaves(params)
    zeros = lambda: tree_map(lambda x: torch.zeros_like(x, dtype=torch.float32), params)
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=leaves[0].device),
                      mu=zeros(), nu=zeros())


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(x.float() ** 2) for x in tree_leaves(tree)))


def adamw_update(cfg: AdamWConfig, grads, state: AdamWState, params, decay):
    """-> (new params, new state, {"grad_norm", "lr"}). ``decay`` is the tree
    of bools that ``decay_mask`` gives (for a tree that the reference holds
    unstacked too, ``tree_map(lambda p: p.ndim >= 2, params)``). Gradients
    are clipped to a global norm of ``grad_clip`` (0: no clipping); the
    reported norm is the raw one."""
    sched = cosine_schedule(cfg)
    gnorm = global_norm(grads)
    clip = (torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
            if cfg.grad_clip > 0 else 1.0)
    step = state.step + 1
    b1c = 1.0 - cfg.beta1 ** step.float()
    b2c = 1.0 - cfg.beta2 ** step.float()
    lr = sched(step)

    def upd(g, m, v, p, dec):
        g = g.float() * clip
        m = cfg.beta1 * m + (1 - cfg.beta1) * g
        v = cfg.beta2 * v + (1 - cfg.beta2) * g * g
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        if dec:
            delta = delta + cfg.weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), m, v

    out = [upd(*xs) for xs in zip(tree_leaves(grads), tree_leaves(state.mu),
                                  tree_leaves(state.nu), tree_leaves(params),
                                  tree_leaves(decay))]
    new_p, new_m, new_v = (tree_unflatten(params, [o[i] for o in out]) for i in range(3))
    return new_p, AdamWState(step=step, mu=new_m, nu=new_v), {"grad_norm": gnorm, "lr": lr}
