"""Checkpoints in the reference's format (``repro.training.checkpoint``):
``ckpt_XXXXXXXX.npz`` with every array under its path in the reference's
parameter tree, ``ckpt_XXXXXXXX.json`` (step, array count, bytes, extra)
and a ``latest`` file holding the last step.

Keys are the reference's: ``params/`` then the path through its tree, dict
keys by name and tuple entries as ``[i]`` (``params/blocks/[0]/mixer/wq``,
the stacked layers of period position 0), and for the optimizer
``opt/.step``, ``opt/.mu/...`` and ``opt/.nu/...``. The port writes through
``convert.params_to_reference`` (restacking its layers) and reads through
``convert.params_from_reference``, so a checkpoint that either package
writes restores in the other.
"""
from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from repro_torch.models.convert import params_from_reference, params_to_reference
from repro_torch.training.optimizer import AdamWState


def _flatten(tree, prefix: str, out: dict) -> dict:
    """The reference's flattening: dict keys sorted (as ``jax.tree`` sorts
    them), tuple entries as ``[i]``."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            _flatten(tree[k], f"{prefix}{k}/", out)
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            _flatten(t, f"{prefix}[{i}]/", out)
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def _unflatten(data, prefix: str) -> dict:
    """The arrays under ``prefix`` as a nested tree, ``[i]`` levels as tuples."""
    tree: dict = {}
    for key in data.files:
        if key.startswith(prefix):
            *path, leaf = key[len(prefix):].split("/")
            node = tree
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = data[key]

    def tuples(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.startswith("[") for k in node):
            return tuple(tuples(node[f"[{i}]"]) for i in range(len(node)))
        return {k: tuples(v) for k, v in node.items()}
    return tuples(tree)


def save_checkpoint(path: str, step: int, cfg, params, opt_state: Optional[AdamWState] = None,
                    extra: Optional[dict] = None) -> str:
    """Write step ``step`` of the model ``cfg``'s ``params`` (and optimizer
    state) under ``path``; returns the npz file's name."""
    os.makedirs(path, exist_ok=True)
    fn = os.path.join(path, f"ckpt_{step:08d}")
    payload = _flatten(params_to_reference(cfg, params), "params/", {})
    if opt_state is not None:
        payload["opt/.step"] = np.asarray(opt_state.step.cpu().numpy(), np.int32)
        _flatten(params_to_reference(cfg, opt_state.mu), "opt/.mu/", payload)
        _flatten(params_to_reference(cfg, opt_state.nu), "opt/.nu/", payload)
    np.savez(fn + ".npz", **payload)
    manifest = {"step": step, "n_arrays": len(payload),
                "bytes": int(sum(v.nbytes for v in payload.values())),
                "extra": extra or {}}
    with open(fn + ".json", "w") as f:
        json.dump(manifest, f, indent=2)
    with open(os.path.join(path, "latest"), "w") as f:
        f.write(f"{step:08d}")
    return fn + ".npz"


def latest_step(path: str) -> Optional[int]:
    p = os.path.join(path, "latest")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return int(f.read().strip())


def restore_checkpoint(path: str, step: int, cfg, device="cpu"):
    """-> (params, AdamWState or None when the file holds none, manifest),
    the tensors on ``device``."""
    fn = os.path.join(path, f"ckpt_{step:08d}")
    with np.load(fn + ".npz") as data:
        params = params_from_reference(cfg, _unflatten(data, "params/"), device)
        opt = None
        if "opt/.step" in data.files:
            o = _unflatten(data, "opt/")
            opt = AdamWState(step=torch.as_tensor(np.asarray(o[".step"], np.int32),
                                                  device=device),
                             mu=params_from_reference(cfg, o[".mu"], device),
                             nu=params_from_reference(cfg, o[".nu"], device))
    with open(fn + ".json") as f:
        manifest = json.load(f)
    return params, opt, manifest
