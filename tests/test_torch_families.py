"""The port's MoE, SSM, hybrid, VLM and audio families held against the
reference on converted parameters, at ``reduced()`` sizes on the CPU.

* Per mixer: ``apply_moe_exact`` (routed and shared experts, the router's
  aux loss), Mamba, mLSTM and sLSTM — the full sequence, a run of one-token
  steps, and the state a prefill builds — against the reference functions.
* Per config (qwen2-moe-a2.7b, kimi-k2-1t-a32b with its dense first layer,
  xlstm-350m, jamba-v0.1-52b, paligemma-3b with and without image patches,
  whisper-base with its encoder frames): prefill logits and 8 decode steps
  at a scalar position and at per-slot positions.
* Serving: the port's RaLMSeq gives the reference RaLMSeq's tokens for one
  MoE, one SSM and one hybrid reduced stack, and the port's fleet gives the
  port's RaLMSeq tokens with one KB call per round; recurrent states obey
  the engines' snapshot rules; whisper-base serves through engines that
  hand its frames to every prefill, as the reference's do.

Tolerance rtol = atol = 1e-4, as in ``tests/test_torch_model.py``: fp32 in
both packages, sums in another order (and Mamba's in-chunk scan by doubling
where the reference runs ``lax.associative_scan``).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import RaLMConfig as RefRaLMConfig
from repro.configs import get_config, reduced
from repro.launch.serve import build_stack as ref_build_stack
from repro.launch.serve import make_server as ref_make_server
from repro.models import moe as RMOE
from repro.serving.engine import ServeEngine as RefServeEngine
from repro.models import ssm as RSSM
from repro.models.model import Model as RefModel
from repro.models.model import _final_state as ref_final_state
from repro_torch.configs import RaLMConfig
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.launch.serve import build_stack, make_server, variant_config
from repro_torch.models import moe as TMOE
from repro_torch.models import ssm as TSSM
from repro_torch.models.convert import _tensors, params_from_reference
from repro_torch.models.model import Model, _final_state, signatures
from repro_torch.serving.batched import BatchedServeEngine
from repro_torch.serving.engine import ServeEngine
from repro_torch.training.data import make_queries

# six xdist workers share the host's cores: one torch thread each
torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
CONFIGS = ["qwen2-moe-a2.7b", "kimi-k2-1t-a32b", "xlstm-350m", "jamba-v0.1-52b",
           "paligemma-3b", "whisper-base"]


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), b.detach().numpy(), **TOL)


def _tree_close(a, b):
    """Every leaf of a reference dict against the port's dict of tensors."""
    assert set(a) == set(b)
    for k in a:
        _close(a[k], b[k])


def _cfgs(name):
    return reduced(get_config(name)), t_reduced(t_get_config(name))


# ---------------------------------------------------------------------------------
# per mixer
# ---------------------------------------------------------------------------------
MIXERS = {  # kind -> (config, reference init, apply, state init, step)
    "mamba": ("jamba-v0.1-52b", RSSM.init_mamba, "apply_mamba", "init_mamba_state",
              "apply_mamba_step"),
    "mlstm": ("xlstm-350m", RSSM.init_mlstm, "apply_mlstm", "init_mlstm_state",
              "apply_mlstm_step"),
    "slstm": ("xlstm-350m", RSSM.init_slstm, "apply_slstm", "init_slstm_state",
              "apply_slstm_step"),
}


def _mixer(kind, seed=0):
    name, init, *_ = MIXERS[kind]
    cfg, tcfg = _cfgs(name)
    rp = jax.tree.map(np.asarray, init(jax.random.PRNGKey(seed), cfg, jnp.float32))
    return cfg, tcfg, rp, _tensors(rp, "cpu")


@pytest.mark.parametrize("S", [1, 45, 70])
@pytest.mark.parametrize("kind", ["mamba", "mlstm", "slstm"])
def test_recurrent_mixer_full_sequence_matches_reference(kind, S):
    """S = 45 and 70 cross the reduced configs' 32-step chunk (Mamba's
    doubling scan and mLSTM's chunkwise form carry the state over it)."""
    cfg, tcfg, rp, tp = _mixer(kind)
    x = np.random.default_rng(S).standard_normal((2, S, cfg.d_model)).astype(np.float32)
    want = getattr(RSSM, MIXERS[kind][2])(rp, cfg, jnp.asarray(x))
    _close(want, getattr(TSSM, MIXERS[kind][2])(tp, tcfg, torch.from_numpy(x)))


@pytest.mark.parametrize("kind", ["mamba", "mlstm", "slstm"])
def test_recurrent_mixer_steps_and_prefill_state_match_reference(kind):
    """Twelve one-token steps from the zero state: each output and each
    state against the reference's; then the state a prefill builds from the
    same tokens (``_final_state``) against the reference's."""
    cfg, tcfg, rp, tp = _mixer(kind, seed=1)
    _, _, _, init_state, step = MIXERS[kind]
    x = np.random.default_rng(2).standard_normal((3, 12, cfg.d_model)).astype(np.float32)
    r_st = getattr(RSSM, init_state)(cfg, 3, jnp.float32)
    t_st = getattr(TSSM, init_state)(tcfg, 3)
    for t in range(12):
        r_out, r_st = getattr(RSSM, step)(rp, cfg, jnp.asarray(x[:, t:t + 1]), r_st)
        t_out, t_st = getattr(TSSM, step)(tp, tcfg, torch.from_numpy(x[:, t:t + 1]), t_st)
        _close(r_out, t_out)
        _tree_close(r_st, t_st)
    _tree_close(ref_final_state(rp, cfg, kind, jnp.asarray(x)),
                _final_state(tp, tcfg, kind, torch.from_numpy(x)))
    _tree_close(r_st, _final_state(tp, tcfg, kind, torch.from_numpy(x)))


@pytest.mark.parametrize("name", ["qwen2-moe-a2.7b", "kimi-k2-1t-a32b", "jamba-v0.1-52b"])
@pytest.mark.parametrize("S", [1, 9])
def test_apply_moe_exact_matches_reference(name, S):
    """Routed experts (top-k of the reduced config), the shared expert where
    the config has one (qwen2-moe, kimi), and the aux loss."""
    cfg, tcfg = _cfgs(name)
    rp = jax.tree.map(np.asarray, RMOE.init_moe(jax.random.PRNGKey(3), cfg, jnp.float32))
    assert ("shared" in rp) == bool(cfg.moe.num_shared_experts)
    x = np.random.default_rng(S).standard_normal((2, S, cfg.d_model)).astype(np.float32)
    r_out, r_aux = RMOE.apply_moe_exact(rp, cfg, jnp.asarray(x))
    t_out, t_aux = TMOE.apply_moe_exact(_tensors(rp, "cpu"), tcfg, torch.from_numpy(x))
    _close(r_out, t_out)
    _close(r_aux, t_aux)


def test_moe_router_picks_the_reference_experts():
    cfg, tcfg = _cfgs("qwen2-moe-a2.7b")
    rp = jax.tree.map(np.asarray, RMOE.init_moe(jax.random.PRNGKey(4), cfg, jnp.float32))
    x = np.random.default_rng(5).standard_normal((64, cfg.d_model)).astype(np.float32)
    rw, ri, _ = RMOE._router(rp, cfg.moe, jnp.asarray(x))
    tw, ti, _ = TMOE._router(_tensors(rp, "cpu"), tcfg.moe, torch.from_numpy(x))
    assert np.array_equal(np.asarray(ri), ti.numpy())
    _close(rw, tw)


# ---------------------------------------------------------------------------------
# per config
# ---------------------------------------------------------------------------------
class _JitRef:
    """The reference model's prefill and decode step compiled once per shape
    (its eager op-by-op dispatch is what costs time here, not the
    arithmetic)."""

    def __init__(self, ref):
        self.prefill = jax.jit(ref.prefill, static_argnames=("window_cache",))
        self.decode_step = jax.jit(ref.decode_step)


@functools.lru_cache(maxsize=None)
def _pair(name):
    """(reference config, reference model, its params as numpy, the port's
    model, the converted params) of a reduced config, built once."""
    cfg, tcfg = _cfgs(name)
    ref = RefModel(cfg)
    tree = jax.tree.map(np.asarray, ref.init(jax.random.PRNGKey(0)))
    return cfg, _JitRef(ref), tree, Model(tcfg), params_from_reference(tcfg, tree)


# every config without patches, and the VLM with its image patches too
CASES = [(name, False) for name in CONFIGS] + [("paligemma-3b", True)]


def _patches(cfg, batch, with_patches, seed=9):
    """The prefill's ``extra`` for the reference and the port: the VLM's
    image patches where asked; the audio model's encoder frames always (its
    prefill needs them)."""
    rng = np.random.default_rng(seed)
    if cfg.family == "audio":
        f = rng.standard_normal((batch, cfg.encoder_frames, cfg.d_model)).astype(np.float32)
        return {"frames": jnp.asarray(f)}, {"frames": torch.from_numpy(f)}
    if not with_patches:
        return None, None
    p = rng.standard_normal((batch, cfg.vision_patches, cfg.d_model)).astype(np.float32)
    return {"patches": jnp.asarray(p)}, {"patches": torch.from_numpy(p)}


@pytest.mark.parametrize("name,with_patches", CASES)
def test_prefill_then_scalar_decode_matches_reference(name, with_patches):
    """Prefill logits, then 8 greedy decode steps at a scalar position past
    a W = 48 ring; the VLM also with its image patches (a bidirectional
    prefix)."""
    cfg, ref, tree, port, params = _pair(name)
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (1, 40)).astype(np.int32)
    r_extra, t_extra = _patches(cfg, 1, with_patches)
    r_last, r_st, r_pos = ref.prefill(tree, jnp.asarray(toks), extra=r_extra,
                                      window_cache=48)
    t_last, t_st, t_pos = port.prefill(params, torch.from_numpy(toks), extra=t_extra,
                                       window_cache=48)
    assert int(r_pos) == t_pos == 40 + (cfg.vision_patches if with_patches else 0)
    _close(r_last, t_last)
    for i in range(8):
        tok = int(np.argmax(np.asarray(r_last[0])))
        assert tok == int(t_last[0].argmax())
        r_last, r_st = ref.decode_step(tree, r_st, jnp.asarray([tok], jnp.int32),
                                       jnp.int32(t_pos + i))
        t_last, t_st = port.decode_step(params, t_st, torch.tensor([tok]), t_pos + i)
        _close(r_last, t_last)
    for r, t in zip(r_st, t_st):
        jax.tree.map(lambda a, b: _close(a, b), r, t)


@pytest.mark.parametrize("name,with_patches", CASES)
def test_per_slot_decode_matches_reference(name, with_patches):
    """Three slots prefilled at their own lengths, their states stacked, then
    8 decode steps at per-slot positions (the fleet's decode)."""
    cfg, ref, tree, port, params = _pair(name)
    rng = np.random.default_rng(7)
    r_rows, t_rows, r_last, t_last, pos = [], [], [], [], []
    for b, n in enumerate((20, 33, 45)):
        toks = rng.integers(0, cfg.vocab_size, (1, n)).astype(np.int32)
        r_extra, t_extra = _patches(cfg, 1, with_patches, seed=b)
        rl, rs, rp = ref.prefill(tree, jnp.asarray(toks), extra=r_extra, window_cache=48)
        tl, ts, tp = port.prefill(params, torch.from_numpy(toks), extra=t_extra,
                                  window_cache=48)
        r_rows.append(rs), t_rows.append(ts), r_last.append(rl), t_last.append(tl)
        pos.append(tp)
    r_st = [jax.tree.map(lambda *xs: jnp.concatenate(xs), *[r[i] for r in r_rows])
            for i in range(cfg.num_layers)]
    t_st = [jax.tree.map(lambda *xs: torch.cat(xs), *[t[i] for t in t_rows])
            for i in range(cfg.num_layers)]
    r_l, t_l = jnp.concatenate(r_last), torch.cat(t_last)
    pos = np.asarray(pos, np.int32)
    for _ in range(8):
        tok = np.argmax(np.asarray(r_l), -1).astype(np.int32)
        r_l, r_st = ref.decode_step(tree, r_st, jnp.asarray(tok), jnp.asarray(pos))
        t_l, t_st = port.decode_step(params, t_st, torch.from_numpy(tok).long(),
                                     torch.from_numpy(pos))
        _close(r_l, t_l)
        pos = pos + 1


@pytest.mark.parametrize("name", CONFIGS)
def test_init_matches_reference_shapes(name):
    """The port's own init draws every leaf the converted reference tree has,
    at the same shape, layer by layer."""
    cfg, _, _, port, params = _pair(name)
    mine = port.init(torch.Generator().manual_seed(0))
    shapes = lambda t: jax.tree.map(lambda a: tuple(a.shape), t)   # noqa: E731
    assert shapes(mine) == shapes(params)
    assert [("moe" in p, "ffn" in p) for p in mine["layers"]] == \
        [(moe, not moe and cfg.d_ff > 0) for _, moe in signatures(cfg)]


@pytest.mark.parametrize("name", CONFIGS)
def test_decode_step_leaves_recurrent_state_alone(name):
    """A decode step builds new state tensors, for SSM layers as for ring KV,
    so an engine snapshot of the old state stays valid."""
    cfg, _, _, port, params = _pair(name)
    _, st, pos = port.prefill(params, torch.arange(30)[None] % cfg.vocab_size,
                              extra=_patches(cfg, 1, False)[1], window_cache=32)
    before = jax.tree.map(torch.clone, st)
    port.decode_step(params, st, torch.tensor([3]), pos)
    port.decode_step(params, st, torch.tensor([3]), torch.tensor([pos]))
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(a.numpy(), b.numpy()),
                 before, st)


# ---------------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------------
SERVE_ARCHS = ["qwen2-moe-a2.7b", "xlstm-350m", "jamba-v0.1-52b"]   # MoE, SSM, hybrid
N_DOCS, MAX_NEW = 800, 16


@pytest.fixture(scope="module", params=SERVE_ARCHS)
def served(request):
    """The reference stack (numpy backend) and the port's (kernel backend,
    CPU) of one reduced arch on the reference's parameters, with the
    reference RaLMSeq's tokens for three prompts."""
    arch = request.param
    ref = ref_build_stack("edr", n_docs=N_DOCS, arch=arch,
                          rcfg=RefRaLMConfig(max_new_tokens=MAX_NEW))
    port = build_stack("edr", n_docs=N_DOCS, arch=arch, device="cpu", backend="kernel",
                       rcfg=RaLMConfig(max_new_tokens=MAX_NEW))
    port.params = params_from_reference(port.cfg, jax.tree.map(np.asarray, ref.params))
    prompts = [(q * 12)[:40] for q in make_queries(port.docs, 3)]
    want = [ref_make_server(ref, scheduler="seq").serve(p).tokens for p in prompts]
    assert all(len(t) == MAX_NEW for t in want)
    return port, prompts, want


def test_port_ralmseq_matches_reference_on_new_families(served):
    port, prompts, want = served
    assert port.cfg.family in ("moe", "ssm", "hybrid")
    seq = make_server(port, scheduler="seq")
    assert [seq.serve(p).tokens for p in prompts] == want


@pytest.mark.parametrize("async_fleet", [False, True])
def test_port_fleet_matches_port_ralmseq_one_call_per_round(served, async_fleet):
    port, prompts, want = served
    got = [make_server(port, scheduler="seq").serve(p).tokens for p in prompts]
    st = dataclasses.replace(port, engine=None, rcfg=variant_config("psa", port.rcfg))
    backend = st.retriever.backend
    with make_server(st, scheduler="fixed", n_slots=3, async_fleet=async_fleet) as fleet:
        c0 = backend.calls
        fr = fleet.serve(prompts)
    assert [r.tokens for r in fr.results] == got == want
    assert fr.kb_calls == fr.rounds + 1 == backend.calls - c0
    assert fr.kb_errors == 0 and fr.degraded_rounds == 0


def test_batched_engine_keeps_idle_and_rewound_recurrent_rows(served):
    """With recurrent state in the bundle: a lockstep step over slots 0 and 1
    leaves idle slot 2's rows as they were, and a restore puts slot 0's rows
    back to the snapshot's bytes; replaying gives the same tokens."""
    port, prompts, _ = served
    eng = BatchedServeEngine(port.model, port.params, 3, cache_window=64)
    for b, p in enumerate(prompts):
        eng.start(b, p)
    snap = eng.snapshot(0)
    kept = jax.tree.map(lambda t: t[2].clone(), eng._state)
    first = eng.gen([0, 1], [6, 6])[0]
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(a.numpy(), b[2].numpy()),
                 kept, eng._state)
    eng.restore(0, snap)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(a[0].numpy(), b[0].numpy()),
                 eng._state, snap[2][0])
    assert eng.gen([0], [6]) == [first]


def test_audio_stack_serves_with_frames_through_the_engines():
    """whisper-base, reduced, on the reference's parameters: the port's
    RaLMSeq over an engine that hands the frames to every prefill gives the
    reference RaLMSeq's tokens (its engine holds the same frames), and the
    3-slot psa fleet over a batched engine with the frames gives them too,
    with one KB call per round; the cross K/V that a decode step hands on
    is shared by the engine's bundle, not copied."""
    ref = ref_build_stack("edr", n_docs=N_DOCS, arch="whisper-base",
                          rcfg=RefRaLMConfig(max_new_tokens=MAX_NEW))
    port = build_stack("edr", n_docs=N_DOCS, arch="whisper-base", device="cpu",
                       backend="kernel", rcfg=RaLMConfig(max_new_tokens=MAX_NEW))
    assert port.cfg.family == "audio"
    port.params = params_from_reference(port.cfg, jax.tree.map(np.asarray, ref.params))
    r_extra, t_extra = _patches(port.cfg, 1, False, seed=5)
    prompts = [(q * 12)[:40] for q in make_queries(port.docs, 3)]
    reng = RefServeEngine(ref.model, ref.params, cache_window=512, extra=r_extra)
    want = [ref_make_server(ref, scheduler="seq", engine=reng).serve(p).tokens
            for p in prompts]
    eng = ServeEngine(port.model, port.params, cache_window=512, extra=t_extra)
    assert [make_server(port, scheduler="seq", engine=eng).serve(p).tokens
            for p in prompts] == want
    st = dataclasses.replace(port, engine=None, rcfg=variant_config("psa", port.rcfg))
    beng = BatchedServeEngine(port.model, port.params, 3, cache_window=512, extra=t_extra)
    backend = st.retriever.backend
    with make_server(st, scheduler="fixed", n_slots=3, engine=beng) as fleet:
        c0 = backend.calls
        fr = fleet.serve(prompts)
    assert [r.tokens for r in fr.results] == want
    assert fr.kb_calls == fr.rounds + 1 == backend.calls - c0
    cross = beng._state[0]["cross_k"]
    beng.gen([0], [1])
    assert beng._state[0]["cross_k"] is cross
