"""The port's stacked decode (``Model.init_decode_state_stacked`` /
``decode_step_stacked``, the dry-run's decode) held against the reference's
on converted parameters, for every config of the registry at ``reduced()``
size (kimi-k2-1t-a32b also at 3 layers, so that a prefix layer and a stacked
stage of two repeats meet), B = 2, ring window W = 24.

* port stacked == reference stacked, on the logits and on every leaf of the
  new stacked state, MoE configs included (both run the capacity MoE);
* port stacked == port flat ``decode_step`` for every config without MoE;
* the stacked state has the reference's leaves (``jax.eval_shape``) and
  initial values;
* per-slot (B,) positions give each slot's row of a B = 1 run at its own
  position.

Tolerances: against the reference, and per-slot against alone, rtol = atol
= 1e-5 (fp32 in both packages, sums in another order; a B = 1 and a B = 2
product round apart in the last bits; the reference's own stacked-vs-flat
bound is 2e-3). Port stacked against port flat: the same operations on the
same numbers, held to rtol = 0, atol = 1e-6.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import REGISTRY, get_config, reduced
from repro.models.model import Model as RefModel
from repro.models.model import layer_plan as ref_layer_plan
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.models.convert import params_from_reference
from repro_torch.models.model import Model, layer_plan

# six xdist workers share the host's cores: one torch thread each
torch.set_num_threads(1)

TOL_REF = dict(rtol=1e-5, atol=1e-5)
TOL_SELF = dict(rtol=0, atol=1e-6)
B, W, S_TEXT, STEPS = 2, 24, 10, 3
CASES = [(a, 2) for a in sorted(REGISTRY)] + [("kimi-k2-1t-a32b", 3)]


def _stack_ref(cfg, flat):
    """A per-layer reference state list in the stacked layout (as
    ``tests/test_decode_stacked.py`` stacks it)."""
    n_pre, period, n_rep = ref_layer_plan(cfg)
    stages = []
    for j in range(period if n_rep else 0):
        reps = [flat[n_pre + r * period + j] for r in range(n_rep)]
        stages.append(jax.tree.map(lambda *xs: jnp.stack(xs), *reps) if n_rep > 1
                      else reps[0])
    return {"prefix": tuple(flat[:n_pre]), "stages": tuple(stages)}


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return tuple(_torch(v) for v in tree)
    return torch.from_numpy(np.array(tree))


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k], f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _leaves(v, f"{path}/{i}")]
    return [(path, tree)]


def _extra(cfg, key):
    if cfg.family == "audio":
        return {"frames": jax.random.normal(key, (B, cfg.encoder_frames, cfg.d_model)) * 0.1}
    if cfg.family == "vlm":
        return {"patches": jax.random.normal(key, (B, cfg.vision_patches, cfg.d_model)) * 0.1}
    return None


@functools.lru_cache(maxsize=None)
def _case(arch, layers):
    """Reference model and params, the port's from them, and the reference's
    prefill of B = 2 prompts into a W = 24 ring (flat and stacked)."""
    cfg = reduced(get_config(arch), layers=layers)
    tcfg = t_reduced(t_get_config(arch), layers=layers)
    ref = RefModel(cfg)
    key = jax.random.PRNGKey(3)
    tree = ref.init(key)
    params = params_from_reference(tcfg, jax.tree.map(np.asarray, tree))
    toks = jax.random.randint(key, (B, S_TEXT), 0, cfg.vocab_size)
    last, flat, pos = ref.prefill(tree, toks, extra=_extra(cfg, key), window_cache=W)
    tok = jnp.argmax(last, axis=-1).astype(jnp.int32)
    return cfg, ref, tree, Model(tcfg), params, flat, tok, int(pos)


def _assert_trees(want, got, tol, what):
    lw, lg = _leaves(want), _leaves(got)
    assert [p for p, _ in lw] == [p for p, _ in lg], what
    for (path, a), (_, b) in zip(lw, lg):
        assert tuple(np.shape(a)) == tuple(b.shape), (what, path)
        np.testing.assert_allclose(np.asarray(a), b.numpy(), err_msg=f"{what} {path}", **tol)


@pytest.mark.parametrize("arch,layers", CASES)
def test_stacked_decode_matches_reference(arch, layers):
    cfg, ref, tree, port, params, flat, tok, pos = _case(arch, layers)
    r_st = _stack_ref(cfg, flat)
    t_st = _torch(r_st)
    t_tok = torch.from_numpy(np.array(tok))
    for i in range(STEPS):
        r_logits, r_st = ref.decode_step_stacked(tree, r_st, tok, jnp.int32(pos + i))
        t_logits, t_st = port.decode_step_stacked(params, t_st, t_tok, pos + i)
        np.testing.assert_allclose(np.asarray(r_logits), t_logits.numpy(),
                                   err_msg=f"{arch} step {i}", **TOL_REF)
        _assert_trees(r_st, t_st, TOL_REF, f"{arch} step {i} state")
        tok = jnp.argmax(r_logits, -1).astype(jnp.int32)
        t_tok = torch.from_numpy(np.array(tok))


@pytest.mark.parametrize("arch,layers", [c for c in CASES if get_config(c[0]).moe is None])
def test_stacked_decode_matches_flat(arch, layers):
    cfg, _, _, port, params, flat, tok, pos = _case(arch, layers)
    f_st = list(_torch(flat))
    s_st = _torch(_stack_ref(cfg, flat))
    t_tok = torch.from_numpy(np.array(tok))
    for i in range(STEPS):
        f_logits, f_st = port.decode_step(params, f_st, t_tok, pos + i)
        s_logits, s_st = port.decode_step_stacked(params, s_st, t_tok, pos + i)
        torch.testing.assert_close(s_logits, f_logits, **TOL_SELF)
        for a, b in zip(f_st, port.unstack_decode_state(s_st)):
            _assert_trees(_torch(a), b, TOL_SELF, f"{arch} step {i} state")
        t_tok = f_logits.argmax(-1)


@pytest.mark.parametrize("arch,layers", CASES)
def test_stacked_state_has_reference_leaves(arch, layers):
    cfg, ref, _, port, _, _, _, _ = _case(arch, layers)
    want = jax.eval_shape(lambda: ref.init_decode_state_stacked(B, W))
    got = port.init_decode_state_stacked(B, W, device="cpu")
    lw, lg = _leaves(want), _leaves(got)
    assert [p for p, _ in lw] == [p for p, _ in lg]
    for (path, a), (_, b) in zip(lw, lg):
        assert tuple(a.shape) == tuple(b.shape) and b.is_contiguous(), path
        assert str(a.dtype) == str(b.dtype).removeprefix("torch."), path
    _assert_trees(ref.init_decode_state_stacked(B, W), got, dict(rtol=0, atol=0), arch)


@pytest.mark.parametrize("arch,layers", CASES)
def test_per_slot_positions_match_each_slot_alone(arch, layers):
    """Slot 0 at the prefill's next position, slot 1 three further on."""
    cfg, _, _, port, params, flat, tok, pos = _case(arch, layers)
    st = _torch(_stack_ref(cfg, flat))
    t_tok = torch.from_numpy(np.array(tok))
    both = torch.tensor([pos, pos + 3])
    logits, new = port.decode_step_stacked(params, st, t_tok, both)
    n_rep = layer_plan(port.cfg)[2]
    for b in range(B):
        one = {"prefix": tuple(_narrow(s, b, 0) for s in st["prefix"]),
               "stages": tuple(_narrow(s, b, 1 if n_rep > 1 else 0) for s in st["stages"])}
        l1, n1 = port.decode_step_stacked(params, one, t_tok[b:b + 1], int(both[b]))
        torch.testing.assert_close(l1[0], logits[b], **TOL_REF)
        want = {"prefix": tuple(_narrow(s, b, 0) for s in new["prefix"]),
                "stages": tuple(_narrow(s, b, 1 if n_rep > 1 else 0) for s in new["stages"])}
        _assert_trees(want, n1, TOL_REF, f"{arch} slot {b}")


def _narrow(tree, b, dim):
    if isinstance(tree, dict):
        return {k: _narrow(v, b, dim) for k, v in tree.items()}
    return tree.narrow(dim, b, 1).contiguous()
