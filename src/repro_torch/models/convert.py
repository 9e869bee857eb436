"""Reference parameters <-> port parameters.

``params_from_reference(cfg, tree)`` takes the pytree that the reference's
``Model.init`` returns, with its leaves already turned into numpy arrays by the
caller (this module imports nothing of JAX), and returns the dict
``repro_torch.models.model.Model`` reads; ``params_to_reference(cfg, params)``
is its inverse, numpy leaves in the reference's layout (what a checkpoint
holds). ``stacked_leaves`` tells which of the port's leaves the reference
keeps stacked (one more dimension there: the optimizer's weight decay reads
it). Two layouts to mind:

* the reference stacks its layers for ``lax.scan``: ``tree["prefix"]`` holds
  unstacked leading layers and ``tree["blocks"][j]`` the layers of period
  position j, stacked along a leading axis when they repeat more than once
  (its ``Model._layer_params``); :func:`layer_plan` gives the same split here;
* weights are ``(d_in, d_out)`` in both packages, so no matrix is transposed.

Every leaf is taken as it is, nested dicts included: a MoE layer's router
(d, E), its stacked experts (E, d, f) / (E, f, d) and its ``shared`` expert,
the Mamba, mLSTM and sLSTM mixers' parameters (``models.ssm``), an audio
decoder layer's ``norm_cross`` and ``cross`` attention, and an audio model's
``encoder`` (a tuple of unstacked layers and its ``final_norm``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.model import Model, layer_plan


def _tensors(tree, device, r=None):
    if isinstance(tree, dict):
        return {k: _tensors(v, device, r) for k, v in tree.items()}
    a = np.asarray(tree)
    if r is not None:
        a = a[r]
    return torch.from_numpy(np.array(a, np.float32)).to(device)


def params_from_reference(cfg, tree: dict, device="cpu") -> dict:
    Model(cfg)                                   # raises for unported families
    n_pre, period, n_rep = layer_plan(cfg)
    layers = []
    for i in range(cfg.num_layers):
        if i < n_pre:
            layers.append(_tensors(tree["prefix"][i], device))
            continue
        r, j = divmod(i - n_pre, period)
        stage = tree["blocks"][j]
        layers.append(_tensors(stage, device, r if n_rep > 1 else None))
    out = {"embed": _tensors(tree["embed"], device),
           "final_norm": _tensors(tree["final_norm"], device),
           "layers": layers}
    if "unembed" in tree:
        out["unembed"] = _tensors(tree["unembed"], device)
    if "encoder" in tree:                        # audio: its layers are not stacked
        enc = tree["encoder"]
        out["encoder"] = {"layers": [_tensors(bp, device) for bp in enc["layers"]],
                          "final_norm": _tensors(enc["final_norm"], device)}
    return out


def _arrays(tree):
    if isinstance(tree, dict):
        return {k: _arrays(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


def _stack(trees: list):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


def params_to_reference(cfg, params: dict) -> dict:
    """The port's parameters (or any tree of tensors that mirrors them, as
    the optimizer's moments do) -> the reference's layout with numpy leaves:
    ``prefix``, a tuple of the unstacked leading layers, and ``blocks``, one
    entry per period position, its layers stacked along a new leading axis
    when they repeat more than once (:func:`layer_plan`); the audio
    encoder's layers stay a tuple."""
    n_pre, period, n_rep = layer_plan(cfg)
    layers = [_arrays(bp) for bp in params["layers"]]
    blocks = []
    for j in range(period if n_rep else 0):
        reps = [layers[n_pre + r * period + j] for r in range(n_rep)]
        blocks.append(_stack(reps) if n_rep > 1 else reps[0])
    out = {k: _arrays(params[k]) for k in ("embed", "final_norm", "unembed") if k in params}
    out.update(prefix=tuple(layers[:n_pre]), blocks=tuple(blocks))
    if "encoder" in params:
        enc = params["encoder"]
        out["encoder"] = {"layers": tuple(_arrays(bp) for bp in enc["layers"]),
                          "final_norm": _arrays(enc["final_norm"])}
    return out


def stacked_leaves(cfg, params: dict) -> dict:
    """A tree like ``params`` with True at each leaf whose reference
    counterpart is stacked (a layer past the prefix of a plan that repeats
    its period more than once: it has one more leading dimension there)
    and False elsewhere."""
    def mark(tree, v):
        if isinstance(tree, dict):
            return {k: mark(t, v) for k, t in tree.items()}
        return [mark(t, v) for t in tree] if isinstance(tree, list) else v

    n_pre, _, n_rep = layer_plan(cfg)
    out = {k: mark(t, False) for k, t in params.items() if k != "layers"}
    out["layers"] = [mark(bp, i >= n_pre and n_rep > 1)
                     for i, bp in enumerate(params["layers"])]
    return out
