"""The port's training path held against the reference on the CPU: the
schedule, one AdamW update (clipping and the decay rule the reference's
layer stacking implies), the microbatched step, a 5-step loss trajectory,
checkpoints across the two packages, the data sources, and the CLI.

Tolerances: schedule 1e-7 relative; AdamW update rtol = 1e-5, atol = 1e-7
(identical gradients in, fp32 arithmetic in another order); train steps and
the trajectory rtol = atol = 1e-4 on losses, grad norms and first moments,
and 2e-5 absolute on parameters (gradients in another summation order, then
Adam's normalised step). Where a gradient element is within fp32 noise of
zero (the reference's first moment below 1e-6 in magnitude), Adam's step
maps the two packages' roundings to steps of up to lr in either direction,
so there the bound is 2 lr a step. After several steps such an element's
difference feeds every later gradient, so the trajectory is held on its
losses and grad norms (rtol = atol = 1e-4) and its parameters only to
Adam's own bound, 1.02 lr a step for either package (beta1 0.9, beta2 0.95,
5 steps); checkpoints and data byte for byte.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.models.model import Model as RefModel
from repro.training import checkpoint as RCK
from repro.training import data as RD
from repro.training import optimizer as ROPT
from repro.training.trainer import make_train_step as ref_make_train_step
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.models.convert import params_from_reference, params_to_reference
from repro_torch.models.model import Model
from repro_torch.training import checkpoint as TCK
from repro_torch.training import data as TD
from repro_torch.training import optimizer as TOPT
from repro_torch.tree import tree_leaves, tree_map
from repro_torch.training.trainer import make_train_step, to_device

# six xdist workers share the host's cores: one torch thread each
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
UPDATE_TOL = dict(rtol=1e-5, atol=1e-7)
LOSS_TOL = dict(rtol=1e-4, atol=1e-4)
PARAM_ATOL = 2e-5


def _pair(name, seed=0):
    cfg, tcfg = reduced(get_config(name)), t_reduced(t_get_config(name))
    ref = RefModel(cfg)
    tree = jax.tree.map(np.asarray, ref.init(jax.random.PRNGKey(seed)))
    return cfg, tcfg, ref, tree, params_from_reference(tcfg, tree)


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


def _assert_tree_close(tcfg, ref_tree, port_tree, **tol):
    """A reference-layout tree against a port tree, leaf by leaf, through
    the port's restacking."""
    want = jax.tree_util.tree_leaves_with_path(_np_tree(ref_tree))
    got = dict(jax.tree_util.tree_leaves_with_path(params_to_reference(tcfg, port_tree)))
    assert len(want) == len(got)
    for path, w in want:
        np.testing.assert_allclose(got[path], w, err_msg=jax.tree_util.keystr(path), **tol)


def _assert_params_close(tcfg, ref_params, port_params, ref_mu, lr_sum: float):
    """Parameters after Adam steps within PARAM_ATOL where the reference's
    first moment is at least 1e-6 in magnitude, and within 2 x (the sum of
    the steps' lr) where it is smaller (module docstring)."""
    got = dict(jax.tree_util.tree_leaves_with_path(params_to_reference(tcfg, port_params)))
    mu = dict(jax.tree_util.tree_leaves_with_path(_np_tree(ref_mu)))
    for path, w in jax.tree_util.tree_leaves_with_path(_np_tree(ref_params)):
        noisy = np.abs(mu[path]) < 1e-6
        err = np.abs(got[path] - w)
        assert err[~noisy].max(initial=0) <= PARAM_ATOL, jax.tree_util.keystr(path)
        assert err[noisy].max(initial=0) <= 2 * lr_sum, jax.tree_util.keystr(path)


def _assert_tree_equal(ref_tree, port_ref_tree):
    want = jax.tree_util.tree_leaves_with_path(_np_tree(ref_tree))
    got = dict(jax.tree_util.tree_leaves_with_path(port_ref_tree))
    assert len(want) == len(got)
    for path, w in want:
        g = got[path]
        assert g.dtype == w.dtype and g.shape == w.shape, jax.tree_util.keystr(path)
        assert g.tobytes() == w.tobytes(), jax.tree_util.keystr(path)


# ---------------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------------
def test_cosine_schedule_matches_reference():
    cfg = ROPT.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    tcfg = TOPT.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    assert TOPT.AdamWConfig() == TOPT.AdamWConfig(**ROPT.AdamWConfig().__dict__)
    ref, port = ROPT.cosine_schedule(cfg), TOPT.cosine_schedule(tcfg)
    for step in (0, 1, 5, 10, 11, 55, 99, 100, 150):
        np.testing.assert_allclose(float(port(torch.tensor(step))),
                                   float(ref(jnp.asarray(step))), rtol=1e-7, atol=0)


@pytest.mark.parametrize("name,plan", [("llama3.2-1b", (0, 1, 2)),
                                       ("kimi-k2-1t-a32b", (1, 1, 1))])
def test_one_adamw_update_matches_reference(name, plan):
    """Random gradients with a global norm far above ``grad_clip`` (so the
    clip scales them), weight decay 0.1, from a non-zero state: params,
    moments, step, grad norm and lr against the reference. llama's plan
    stacks its 2 layers (their norms are decayed), kimi's keeps its dense
    first layer in a prefix (1-D leaves not decayed)."""
    cfg, tcfg, _, tree, params = _pair(name)
    from repro_torch.models.model import layer_plan
    assert layer_plan(tcfg) == plan
    g = np.random.default_rng(0)
    rnd = lambda t: jax.tree.map(
        lambda a: g.standard_normal(a.shape).astype(np.float32), t)
    grads, mu, nu = rnd(tree), rnd(tree), jax.tree.map(np.abs, rnd(tree))
    ocfg = dict(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1, grad_clip=1.0)
    r_state = ROPT.AdamWState(step=jnp.int32(3), mu=mu, nu=nu)
    r_p, r_st, r_m = ROPT.adamw_update(ROPT.AdamWConfig(**ocfg), grads, r_state, tree)
    t_state = TOPT.AdamWState(step=torch.tensor(3, dtype=torch.int32),
                              mu=params_from_reference(tcfg, mu),
                              nu=params_from_reference(tcfg, nu))
    t_p, t_st, t_m = TOPT.adamw_update(TOPT.AdamWConfig(**ocfg),
                                       params_from_reference(tcfg, grads), t_state, params,
                                       TOPT.decay_mask(tcfg, params))
    assert float(r_m["grad_norm"]) > 10 * ocfg["grad_clip"]
    np.testing.assert_allclose(float(t_m["grad_norm"]), float(r_m["grad_norm"]), rtol=1e-6)
    np.testing.assert_allclose(float(t_m["lr"]), float(r_m["lr"]), rtol=1e-7)
    assert int(t_st.step) == int(r_st.step) == 4
    _assert_tree_close(tcfg, r_p, t_p, **UPDATE_TOL)
    _assert_tree_close(tcfg, r_st.mu, t_st.mu, **UPDATE_TOL)
    _assert_tree_close(tcfg, r_st.nu, t_st.nu, **UPDATE_TOL)


@pytest.mark.parametrize("name,decayed", [("llama3.2-1b", True),
                                          ("kimi-k2-1t-a32b", False)])
def test_norm_decay_follows_the_reference_stacking(name, decayed):
    """Zero gradients, lr 1, decay 0.1: the first layer's norm1 goes 1.0 ->
    0.9 where the reference stacks it (llama: one period repeated twice)
    and stays 1.0 in kimi's prefix; final_norm never decays."""
    _, tcfg, _, _, params = _pair(name)
    zeros = tree_map(torch.zeros_like, params)
    cfg = TOPT.AdamWConfig(lr=1.0, warmup_steps=0, total_steps=1, min_lr_ratio=1.0,
                           weight_decay=0.1)
    new, _, _ = TOPT.adamw_update(cfg, zeros, TOPT.init_adamw(params), params,
                                  TOPT.decay_mask(tcfg, params))
    assert torch.allclose(new["layers"][0]["norm1"],
                          torch.full_like(params["layers"][0]["norm1"],
                                          0.9 if decayed else 1.0))
    assert torch.equal(new["final_norm"], params["final_norm"])
    assert torch.allclose(new["embed"], params["embed"] * 0.9)


# ---------------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------------
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)


def _step_pair(name, num_microbatches):
    cfg, tcfg, ref, tree, params = _pair(name)
    r_step = jax.jit(ref_make_train_step(ref, ROPT.AdamWConfig(**OPT),
                                         num_microbatches=num_microbatches))
    t_step = make_train_step(Model(tcfg), TOPT.AdamWConfig(**OPT),
                             num_microbatches=num_microbatches)
    return cfg, tcfg, tree, params, r_step, t_step


def _max_param_diff(a, b):
    return max(float((x - y).abs().max()) for x, y in
               zip(tree_leaves(a), tree_leaves(b)))


def test_microbatched_step_equals_full_batch_and_reference():
    """4 microbatches of 2 against one batch of 8 (the port), and against
    the reference's microbatched step (same params, same batch)."""
    cfg, tcfg, tree, params, r_step, t_step4 = _step_pair("llama3.2-1b", 4)
    t_step1 = make_train_step(Model(tcfg), TOPT.AdamWConfig(**OPT))
    batch = TD.SyntheticLM(cfg.vocab_size, 32, 8).batch(0)
    tb = to_device(batch, "cpu")
    p1, _, m1 = t_step1(params, TOPT.init_adamw(params), tb)
    p4, s4, m4 = t_step4(params, TOPT.init_adamw(params), tb)
    assert _max_param_diff(p1, p4) < 5e-5              # the reference's own bound
    np.testing.assert_allclose(float(m4["loss"]), float(m1["loss"]), **LOSS_TOL)
    r_p, r_st, r_m = r_step(tree, ROPT.init_adamw(tree), batch)
    for k in ("loss", "total", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m4[k]), float(r_m[k]), **LOSS_TOL)
    _assert_tree_close(tcfg, r_st.mu, s4.mu, **LOSS_TOL)
    _assert_params_close(tcfg, r_p, p4, r_st.mu, float(r_m["lr"]))


@pytest.mark.parametrize("name", ["llama3.2-1b", "qwen2-moe-a2.7b"])
def test_five_step_loss_trajectory_matches_reference(name):
    """Five steps on ``SyntheticLM`` batches 1-5 from the same parameters:
    each step's loss, aux and grad norm, and the final parameters."""
    cfg, tcfg, tree, params, r_step, t_step = _step_pair(name, 1)
    data = TD.SyntheticLM(cfg.vocab_size, 32, 4)
    r_p, r_st = tree, ROPT.init_adamw(tree)
    t_p, t_st = params, TOPT.init_adamw(params)
    r_losses, t_losses, lr_sum = [], [], 0.0
    for step in range(1, 6):
        batch = data.batch(step)
        r_p, r_st, r_m = r_step(r_p, r_st, batch)
        t_p, t_st, t_m = t_step(t_p, t_st, to_device(batch, "cpu"))
        r_losses.append([float(r_m[k]) for k in ("loss", "aux", "grad_norm")])
        t_losses.append([float(t_m[k]) for k in ("loss", "aux", "grad_norm")])
        lr_sum += float(r_m["lr"])
    np.testing.assert_allclose(t_losses, r_losses, **LOSS_TOL)
    assert t_losses[-1][0] < t_losses[0][0]
    moved = _max_param_diff(params_from_reference(tcfg, r_p), params)
    assert 0.5 * lr_sum < moved and _max_param_diff(params_from_reference(tcfg, r_p), t_p) \
        <= 2 * 1.02 * lr_sum


# ---------------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------------
CKPT_ARCHS = ["llama3.2-1b", "kimi-k2-1t-a32b", "whisper-base"]


def _stepped(name):
    """Params and a non-zero optimizer state after one reference step."""
    cfg, tcfg, ref, tree, _ = _pair(name)
    step = jax.jit(ref_make_train_step(ref, ROPT.AdamWConfig(**OPT)))
    b = {k: v for k, v in _batch_for(cfg).items()}
    r_p, r_st, _ = step(tree, ROPT.init_adamw(tree), b)
    return cfg, tcfg, _np_tree(r_p), jax.tree.map(np.asarray, r_st)


def _batch_for(cfg):
    b = TD.SyntheticLM(cfg.vocab_size, 16, 2).batch(0)
    if cfg.family == "audio":
        b["frames"] = np.full((2, cfg.encoder_frames, cfg.d_model), 0.1, np.float32)
    return b


@pytest.mark.parametrize("name", CKPT_ARCHS)
def test_reference_checkpoint_restores_in_the_port(name, tmp_path):
    cfg, tcfg, r_p, r_st = _stepped(name)
    RCK.save_checkpoint(str(tmp_path), 7, r_p, r_st, extra={"who": "reference"})
    assert TCK.latest_step(str(tmp_path)) == 7
    params, opt, manifest = TCK.restore_checkpoint(str(tmp_path), 7, tcfg)
    assert manifest["step"] == 7 and manifest["extra"] == {"who": "reference"}
    _assert_tree_equal(r_p, params_to_reference(tcfg, params))
    assert opt.step.dtype == torch.int32 and int(opt.step) == int(r_st.step) == 1
    _assert_tree_equal(r_st.mu, params_to_reference(tcfg, opt.mu))
    _assert_tree_equal(r_st.nu, params_to_reference(tcfg, opt.nu))


@pytest.mark.parametrize("name", CKPT_ARCHS)
def test_port_checkpoint_restores_in_the_reference(name, tmp_path):
    """The port writes (the reference's keys, its stacked layout); the
    reference restores into its own templates, byte for byte; the npz keys
    are the ones the reference writes for the same trees."""
    cfg, tcfg, r_p, r_st = _stepped(name)
    params = params_from_reference(tcfg, r_p)
    opt = TOPT.AdamWState(step=torch.tensor(int(r_st.step), dtype=torch.int32),
                          mu=params_from_reference(tcfg, r_st.mu),
                          nu=params_from_reference(tcfg, r_st.nu))
    TCK.save_checkpoint(str(tmp_path / "port"), 3, tcfg, params, opt)
    assert RCK.latest_step(str(tmp_path / "port")) == 3
    p2, o2, manifest = RCK.restore_checkpoint(str(tmp_path / "port"), 3, r_p, r_st)
    _assert_tree_equal(r_p, _np_tree(p2))
    _assert_tree_equal(r_st, _np_tree(o2))
    RCK.save_checkpoint(str(tmp_path / "ref"), 3, r_p, r_st)
    with np.load(tmp_path / "port" / "ckpt_00000003.npz") as a, \
            np.load(tmp_path / "ref" / "ckpt_00000003.npz") as b:
        assert a.files == b.files
    assert manifest["n_arrays"] == len(a.files)
    back, opt_back, _ = TCK.restore_checkpoint(str(tmp_path / "port"), 3, tcfg)
    for x, y in zip(tree_leaves((params, opt)), tree_leaves((back, opt_back))):
        assert torch.equal(x, y)


def test_restored_state_lines_up_with_fresh_parameters(tmp_path):
    """A checkpoint of ``Model.init`` parameters (dicts in init order) and
    their optimizer state restores (dicts in the file's sorted order) equal
    leaf for leaf, and a train step from restored optimizer state with the
    original parameters gives the step from the original state."""
    from repro_torch.training.trainer import init_train
    cfg = t_reduced(t_get_config("kimi-k2-1t-a32b"))
    model, params, opt = init_train(cfg, torch.Generator().manual_seed(0))
    step = make_train_step(model, TOPT.AdamWConfig(**OPT))
    batch = to_device(TD.SyntheticLM(cfg.vocab_size, 16, 2).batch(0), "cpu")
    _, opt, _ = step(params, opt, batch)
    TCK.save_checkpoint(str(tmp_path), 1, cfg, params, opt)
    back, opt_back, _ = TCK.restore_checkpoint(str(tmp_path), 1, cfg)
    assert list(params["layers"][0]) != list(back["layers"][0])     # other dict orders
    for x, y in zip(tree_leaves((params, opt)), tree_leaves((back, opt_back))):
        assert torch.equal(x, y)
    want, _, _ = step(params, opt, batch)
    got, _, _ = step(params, opt_back, batch)
    for x, y in zip(tree_leaves(want), tree_leaves(got)):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------------
def test_data_sources_are_byte_equal_to_the_reference():
    r, t = RD.SyntheticLM(500, 33, 3, seed=4), TD.SyntheticLM(500, 33, 3, seed=4)
    for step in (0, 1, 17):
        for k in ("tokens", "labels"):
            a, b = r.batch(step)[k], t.batch(step)[k]
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    docs = RD.synthetic_corpus(40, 300, seed=2)
    rc, tc = RD.CorpusLM(docs, 24, 4, eos_id=1), TD.CorpusLM(docs, 24, 4, eos_id=1)
    assert rc.stream.tobytes() == tc.stream.tobytes()
    for step in (0, 5):
        a, b = rc.batch(step), tc.batch(step)
        assert a["tokens"].tobytes() == b["tokens"].tobytes()
        assert a["labels"].tobytes() == b["labels"].tobytes()
    assert next(iter(tc))["tokens"].tobytes() == next(iter(rc))["tokens"].tobytes()


# ---------------------------------------------------------------------------------
# the CLI and the example
# ---------------------------------------------------------------------------------
def _env(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), TMPDIR=str(tmp_path),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    return env


def _losses(out: str) -> list:
    return [float(line.split()[3]) for line in out.splitlines() if line.startswith("step ")]


def test_train_cli_runs_on_the_cpu_and_refuses_a_missing_card(tmp_path):
    ckpt = tmp_path / "ck"
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--arch", "llama3.2-1b", "--reduced", "--steps", "3", "--log-every", "1",
         "--ckpt-dir", str(ckpt), "--ckpt-every", "3"],
        cwd=ROOT, env=_env(tmp_path), capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    losses = _losses(out.stdout)
    assert len(losses) == 3 and np.isfinite(losses).all(), out.stdout
    assert TCK.latest_step(str(ckpt)) == 3
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "llama3.2-1b",
         "--reduced", "--steps", "1"],
        cwd=ROOT, env=_env(tmp_path), capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and "device='cpu'" in out.stderr, out.stderr


def test_example_trains_on_the_cpu(tmp_path):
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "train_e2e_torch.py"), "--device", "cpu",
         "--steps", "2"],
        cwd=ROOT, env=_env(tmp_path), capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "arch=knnlm-247m" in out.stdout and np.isfinite(_losses(out.stdout)).all()
    assert TCK.latest_step(str(tmp_path / "repro_torch_ckpt")) == 2
