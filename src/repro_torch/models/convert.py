"""Reference parameters -> port parameters.

``params_from_reference(cfg, tree)`` takes the pytree that the reference's
``Model.init`` returns, with its leaves already turned into numpy arrays by the
caller (this module imports nothing of JAX), and returns the dict
``repro_torch.models.model.Model`` reads. Two layouts to mind:

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
