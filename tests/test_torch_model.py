"""The port's dense model held against the reference ``Model`` on converted
parameters of ``reduced(get_config("ralm-gpt2-medium"), layers=2, d_model=256)``.

Prefill logits and at least 32 decode steps — scalar and per-slot positions,
past a small ring window W — agree at rtol = atol = 1e-4 (fp32 in both; the
sums run in another order) and give the same greedy argmax at every step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.models import layers as RL
from repro.models.model import Model as RefModel
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.models import layers as TL
from repro_torch.models.convert import params_from_reference
from repro_torch.models.model import Model

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def models():
    cfg = reduced(get_config("ralm-gpt2-medium"), layers=2, d_model=256)
    tcfg = t_reduced(t_get_config("ralm-gpt2-medium"), layers=2, d_model=256)
    assert (tcfg.num_layers, tcfg.d_model, tcfg.num_heads, tcfg.head_dim,
            tcfg.qkv_bias) == (cfg.num_layers, cfg.d_model, cfg.num_heads,
                               cfg.head_dim, cfg.qkv_bias)
    ref = RefModel(cfg)
    tree = ref.init(jax.random.PRNGKey(0))
    # the reference's qkv biases init to zero; make them nonzero so the bias
    # path is exercised
    tree = jax.tree.map(np.asarray, tree)
    rng = np.random.default_rng(1)
    for name in ("bq", "bk", "bv"):
        leaf = tree["blocks"][0]["mixer"][name]
        tree["blocks"][0]["mixer"][name] = (
            0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
    port = Model(tcfg)
    return ref, tree, port, params_from_reference(tcfg, tree)


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), b.numpy(), **TOL)
    assert np.array_equal(np.argmax(np.asarray(a), -1), b.argmax(-1).numpy())


@pytest.mark.parametrize("S,W", [(40, 0), (40, 48), (60, 48)])
def test_prefill_then_scalar_decode(models, S, W):
    """W=0 is the default headroom window; (40, 48) wraps the ring during
    decode; (60, 48) prefills longer than the ring (rolled alignment)."""
    ref, tree, port, params = models
    toks = np.random.default_rng(S + W).integers(0, 512, (1, S)).astype(np.int32)
    r_last, r_st, r_pos = ref.prefill(tree, jnp.asarray(toks), window_cache=W)
    t_last, t_st, t_pos = port.prefill(params, torch.from_numpy(toks), window_cache=W)
    assert int(r_pos) == t_pos == S
    _close(r_last, t_last)
    np.testing.assert_allclose(np.asarray(r_st[1]["k"]), t_st[1]["k"].numpy(), **TOL)
    for i in range(34):
        tok = int(np.argmax(np.asarray(r_last[0])))
        r_last, r_st = ref.decode_step(tree, r_st, jnp.asarray([tok], jnp.int32),
                                       jnp.int32(S + i))
        t_last, t_st = port.decode_step(params, t_st, torch.tensor([tok]), S + i)
        _close(r_last, t_last)


def test_per_slot_decode(models):
    """Three slots at their own absolute positions (the fleet's decode), one
    of them wrapping a W=48 ring."""
    ref, tree, port, params = models
    rng = np.random.default_rng(7)
    W, lens = 48, (20, 33, 45)
    r_rows, t_rows, r_last, t_last = [], [], [], []
    for n in lens:
        toks = rng.integers(0, 512, (1, n)).astype(np.int32)
        rl, rs, _ = ref.prefill(tree, jnp.asarray(toks), window_cache=W)
        tl, ts, _ = port.prefill(params, torch.from_numpy(toks), window_cache=W)
        r_rows.append(rs), t_rows.append(ts), r_last.append(rl), t_last.append(tl)
    r_st = [{k: jnp.concatenate([r[i][k] for r in r_rows]) for k in ("k", "v")}
            for i in range(2)]
    t_st = [{k: torch.cat([t[i][k] for t in t_rows]) for k in ("k", "v")}
            for i in range(2)]
    r_l, t_l = jnp.concatenate(r_last), torch.cat(t_last)
    pos = np.asarray(lens, np.int32)
    for _ in range(32):
        tok = np.argmax(np.asarray(r_l), -1).astype(np.int32)
        r_l, r_st = ref.decode_step(tree, r_st, jnp.asarray(tok), jnp.asarray(pos))
        t_l, t_st = port.decode_step(params, t_st, torch.from_numpy(tok).long(),
                                     torch.from_numpy(pos))
        _close(r_l, t_l)
        pos = pos + 1


def test_decode_step_leaves_its_input_state_alone(models):
    """The ring write is functional: snapshots that hold the old state stay
    valid after a decode step."""
    _, _, port, params = models
    toks = torch.arange(30)[None] % 512
    _, st, pos = port.prefill(params, toks, window_cache=32)
    before = [{k: v.clone() for k, v in s.items()} for s in st]
    port.decode_step(params, st, torch.tensor([3]), pos)
    port.decode_step(params, st, torch.tensor([3]), torch.tensor([pos]))
    assert all(torch.equal(a[k], b[k]) for a, b in zip(before, st) for k in a)


def test_init_shapes_match_reference(models):
    ref, tree, port, params = models
    g = torch.Generator().manual_seed(0)
    mine = port.init(g)
    conv = params
    assert mine.keys() == conv.keys()
    for a, b in zip(mine["layers"], conv["layers"]):
        assert {k: v.shape for k, v in a["mixer"].items()} == \
            {k: v.shape for k, v in b["mixer"].items()}
        assert {k: v.shape for k, v in a["ffn"].items()} == \
            {k: v.shape for k, v in b["ffn"].items()}
    assert mine["embed"].shape == conv["embed"].shape
    assert mine["unembed"].shape == conv["unembed"].shape


@pytest.mark.parametrize("pos_shape", [(1, 7), (3, 1)])
def test_apply_rope_matches_reference(pos_shape):
    """Split-half rotation at a shared run of positions (prefill) and at
    per-slot positions (decode)."""
    rng = np.random.default_rng(sum(pos_shape))
    x = rng.standard_normal((3, pos_shape[1], 4, 64)).astype(np.float32)
    pos = rng.integers(0, 5000, pos_shape).astype(np.int32)
    want = RL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)
    got = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0)
    np.testing.assert_allclose(np.asarray(want), got.numpy(), **TOL)


def test_unported_family_raises():
    with pytest.raises(NotImplementedError):
        Model(t_get_config("qwen2-moe-a2.7b"))
