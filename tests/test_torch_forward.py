"""The port's full-sequence pass (``Model.forward``), its differentiable
attention and the capacity MoE held against the reference on converted
parameters, at ``reduced()`` sizes on the CPU.

* ``forward``: logits and aux loss for every ``ASSIGNED_ARCHS`` config,
  ``ralm-gpt2-medium`` and ``knnlm-247m``, with frames and patches as in
  ``tests/test_arch_smoke.py``, on both attention routes, with
  ``last_only``, and with a sliding window on one dense config.
  Tolerance rtol = atol = 1e-4 (as ``tests/test_torch_model.py``).
* ``blockwise_attention`` at small chunks (value and gradient against
  ``jax.grad``) and ``apply_self_attention`` across its plain / blockwise
  switch at S = 2048. Tolerance 1e-5 absolute on values and gradients.
* Gradients of the training loss against ``jax.grad`` of the reference's
  ``make_loss_fn``, per leaf, for one config of each family. Tolerance
  rtol = 1e-3, atol = 1e-5 (measured worst: 7.3e-7 absolute).
* ``apply_moe``: equal to ``apply_moe_exact`` when capacity is ample, the
  reference's drops when overloaded, and the reference across several
  chunks with a padded last one, aux included (rtol = atol = 1e-4); the
  router's choice among tied experts.
* ``remat`` gives the gradients of the plain pass (1e-6 absolute), and a
  training loss routed through the kernel wrappers raises.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ASSIGNED_ARCHS, get_config, reduced
from repro.models import layers as RL
from repro.models import moe as RMOE
from repro.models.model import Model as RefModel
from repro.training.trainer import make_loss_fn as ref_make_loss_fn
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.prefill_attention import prefill_attention
from repro_torch.models import layers as TL
from repro_torch.models import moe as TMOE
from repro_torch.models.convert import _tensors, params_from_reference
from repro_torch.models.model import Model
from repro_torch.tree import tree_leaves
from repro_torch.training.trainer import make_loss_fn, to_device, value_and_grad

# six xdist workers share the host's cores: one torch thread each
torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=1e-3, atol=1e-5)
FORWARD_ARCHS = list(ASSIGNED_ARCHS) + ["ralm-gpt2-medium", "knnlm-247m"]
FAMILY_ARCHS = {"dense": "llama3.2-1b", "moe": "kimi-k2-1t-a32b", "ssm": "xlstm-350m",
                "hybrid": "jamba-v0.1-52b", "vlm": "paligemma-3b", "audio": "whisper-base"}
B, S = 2, 32


def _batch(cfg, seed=0):
    """``tests/test_arch_smoke.py``'s batch: tokens, labels, and frames or
    patches by family."""
    g = np.random.default_rng(seed)
    b = {"tokens": g.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    b["labels"] = b["tokens"].copy()
    if cfg.family == "audio":
        b["frames"] = g.standard_normal((B, cfg.encoder_frames, cfg.d_model)
                                        ).astype(np.float32) * 0.1
    if cfg.family == "vlm":
        b["patches"] = g.standard_normal((B, cfg.vision_patches, cfg.d_model)
                                         ).astype(np.float32) * 0.1
    return b


def _extra(batch, tensors: bool):
    e = {k: v for k, v in batch.items() if k in ("frames", "patches")}
    if tensors:
        e = {k: torch.from_numpy(v) for k, v in e.items()}
    return e or None


@functools.lru_cache(maxsize=None)
def _pair(name):
    """(reference config, reference model, its params as numpy, the port's
    model, the converted params), built once per config."""
    cfg, tcfg = reduced(get_config(name)), t_reduced(t_get_config(name))
    ref = RefModel(cfg)
    tree = jax.tree.map(np.asarray, ref.init(jax.random.PRNGKey(0)))
    return cfg, ref, tree, Model(tcfg), params_from_reference(tcfg, tree)


@functools.lru_cache(maxsize=None)
def _ref_forward(name, window, last_only):
    cfg, ref, tree, _, _ = _pair(name)
    b = _batch(cfg)
    fn = jax.jit(lambda p, t, e: ref.forward(p, t, extra=e, window=window,
                                             last_only=last_only))
    return jax.tree.map(np.asarray, fn(tree, b["tokens"], _extra(b, False)))


def _close(want, got, tol=TOL):
    np.testing.assert_allclose(np.asarray(want), got.detach().numpy(), **tol)


# ---------------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------------
@pytest.mark.parametrize("differentiable", [False, True], ids=["kernel", "autograd"])
@pytest.mark.parametrize("name", FORWARD_ARCHS)
def test_forward_matches_reference(name, differentiable):
    """Logits (B, S [+ patches], V) and the aux loss (summed over the MoE
    layers' capacity dispatch) on both attention routes."""
    cfg, _, _, port, params = _pair(name)
    b = _batch(cfg)
    want_logits, want_aux = _ref_forward(name, 0, False)
    logits, aux = port.forward(params, torch.from_numpy(b["tokens"]),
                               extra=_extra(b, True), differentiable=differentiable)
    assert logits.shape == want_logits.shape
    _close(want_logits, logits)
    _close(want_aux, aux)


@pytest.mark.parametrize("name", ["llama3.2-1b", "qwen2-moe-a2.7b", "paligemma-3b",
                                  "whisper-base"])
def test_forward_last_only_matches_reference(name):
    """``last_only``: the last position's logits only, on the kernel route
    (the inference prefill's)."""
    cfg, _, _, port, params = _pair(name)
    b = _batch(cfg)
    want_logits, want_aux = _ref_forward(name, 0, True)
    with torch.no_grad():
        logits, aux = port.forward(params, torch.from_numpy(b["tokens"]),
                                   extra=_extra(b, True), last_only=True)
    assert logits.shape == (B, 1, cfg.vocab_size)
    _close(want_logits, logits)
    _close(want_aux, aux)


@pytest.mark.parametrize("differentiable", [False, True], ids=["kernel", "autograd"])
def test_forward_with_sliding_window_matches_reference(differentiable):
    cfg, _, _, port, params = _pair("qwen3-4b")
    b = _batch(cfg)
    want_logits, _ = _ref_forward("qwen3-4b", 8, False)
    logits, _ = port.forward(params, torch.from_numpy(b["tokens"]), window=8,
                             differentiable=differentiable)
    _close(want_logits, logits)
    full, _ = port.forward(params, torch.from_numpy(b["tokens"]))
    assert not torch.allclose(full, logits, atol=1e-3)        # the window bites


# ---------------------------------------------------------------------------------
# differentiable attention
# ---------------------------------------------------------------------------------
ATTN_CASES = {"causal": dict(causal=True), "window": dict(causal=True, window=7),
              "prefix": dict(causal=True, prefix_len=11),
              "bidirectional": dict(causal=False)}


def _qkv(S, H=4, KV=2, hd=16, seed=0):
    g = np.random.default_rng(seed)
    q = g.standard_normal((2, S, H, hd)).astype(np.float32)
    k = g.standard_normal((2, S, KV, hd)).astype(np.float32)
    v = g.standard_normal((2, S, KV, hd)).astype(np.float32)
    cot = g.standard_normal((2, S, H, hd)).astype(np.float32)
    return q, k, v, cot


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_blockwise_attention_value_and_gradient_match_reference(case):
    """q/kv chunks of 16 over S = 50 (4 chunks, the last padded), GQA 4 / 2
    heads: the output and d<out, cot>/d(q, k, v) against ``jax.grad``; and
    the port's blockwise equals its plain form."""
    kw = ATTN_CASES[case]
    q, k, v, cot = _qkv(50)

    def ref_obj(q, k, v):
        out = RL.blockwise_attention(q, k, v, q_chunk=16, kv_chunk=16, **kw)
        return jnp.sum(out * cot), out

    (_, r_out), r_grads = jax.value_and_grad(ref_obj, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = TL.blockwise_attention(tq, tk, tv, q_chunk=16, kv_chunk=16, **kw)
    grads = torch.autograd.grad(torch.sum(out * torch.from_numpy(cot)), (tq, tk, tv))
    tol = dict(rtol=1e-5, atol=1e-5)
    _close(r_out, out, tol)
    for want, got in zip(r_grads, grads):
        _close(want, got, tol)
    plain = TL.plain_attention(*(torch.from_numpy(a) for a in (q, k, v)), **kw)
    _close(plain.numpy(), out, tol)


@pytest.mark.parametrize("S", [2048, 2056])
def test_apply_self_attention_switches_at_the_reference_threshold(S):
    """S <= max(q_chunk, 2048) runs plain attention, above it blockwise (1024
    chunks); both against the reference's ``apply_self_attention`` with
    rope, a window and a prefix, at a narrow width."""
    cfg = dataclasses.replace(reduced(get_config("llama3.2-1b")), d_model=32,
                              num_heads=2, num_kv_heads=1, head_dim=16)
    tcfg = dataclasses.replace(t_reduced(t_get_config("llama3.2-1b")), d_model=32,
                               num_heads=2, num_kv_heads=1, head_dim=16)
    p = jax.tree.map(np.asarray, RL.init_attention(jax.random.PRNGKey(0), cfg, jnp.float32))
    x = np.random.default_rng(1).standard_normal((1, S, 32)).astype(np.float32)
    kw = dict(causal=True, window=1500, prefix_len=5)
    want = RL.apply_self_attention(p, cfg, jnp.asarray(x), jnp.arange(S)[None], **kw)
    got = TL.apply_self_attention(_tensors(p, "cpu"), tcfg, torch.from_numpy(x),
                                  torch.arange(S)[None], **kw)
    _close(want, got, dict(rtol=1e-5, atol=1e-5))


# ---------------------------------------------------------------------------------
# gradients of the training loss
# ---------------------------------------------------------------------------------
@pytest.mark.parametrize("family", list(FAMILY_ARCHS))
def test_loss_gradients_match_jax_grad(family):
    """Per leaf, the port's gradient of loss + aux (differentiable route)
    against ``jax.value_and_grad`` of the reference's ``make_loss_fn``; the
    loss and aux parts too."""
    name = FAMILY_ARCHS[family]
    cfg, ref, tree, port, params = _pair(name)
    b = _batch(cfg, seed=1)
    (r_total, r_parts), r_grads = jax.jit(jax.value_and_grad(
        ref_make_loss_fn(ref), has_aux=True))(tree, b)
    r_grads = params_from_reference(port.cfg, jax.tree.map(np.asarray, r_grads))
    total, parts, grads = value_and_grad(make_loss_fn(port), params, to_device(b, "cpu"))
    _close(r_total, total)
    _close(r_parts["loss"], parts["loss"])
    _close(r_parts["aux"], parts["aux"])
    want, got = tree_leaves(r_grads), tree_leaves(grads)
    assert len(want) == len(got) == len(tree_leaves(params))
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **GRAD_TOL)


def test_remat_gives_the_same_gradients():
    """``remat=True`` (each block recomputed in the backward pass) against
    ``remat=False`` on a MoE config with a dense first layer."""
    cfg, _, _, port, params = _pair("kimi-k2-1t-a32b")
    b = to_device(_batch(cfg, seed=2), "cpu")
    _, _, plain = value_and_grad(make_loss_fn(port), params, b)
    _, _, remat = value_and_grad(make_loss_fn(port, remat=True), params, b)
    for a, c in zip(tree_leaves(plain), tree_leaves(remat)):
        torch.testing.assert_close(a, c, rtol=0, atol=1e-6)


def test_training_through_the_kernel_route_raises():
    """The kernel wrappers have no backward: a loss on the kernel route with
    parameters that require grad raises (on the CPU as on the card); under
    ``torch.no_grad()`` the same call runs."""
    cfg, _, _, port, params = _pair("llama3.2-1b")
    b = to_device(_batch(cfg), "cpu")
    with pytest.raises(RuntimeError, match="differentiable"):
        value_and_grad(make_loss_fn(port, differentiable=False), params, b)
    q, k, v, _ = _qkv(8)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    with pytest.raises(RuntimeError, match="no backward"):
        prefill_attention(tq, tk, tv)
    with pytest.raises(RuntimeError, match="no backward"):
        decode_attention(tq[:, 0], tk, tv, torch.full((2,), 8, dtype=torch.int32))
    with torch.no_grad():
        prefill_attention(tq, tk, tv)
        decode_attention(tq[:, 0], tk, tv, torch.full((2,), 8, dtype=torch.int32))


# ---------------------------------------------------------------------------------
# the capacity MoE
# ---------------------------------------------------------------------------------
def _moe(capacity_factor=None, dispatch_chunk=None, seed=0):
    cfg, tcfg = reduced(get_config("qwen2-moe-a2.7b")), t_reduced(t_get_config("qwen2-moe-a2.7b"))
    kw = {k: v for k, v in (("capacity_factor", capacity_factor),
                            ("dispatch_chunk", dispatch_chunk)) if v is not None}
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **kw))
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe, **kw))
    rp = jax.tree.map(np.asarray, RMOE.init_moe(jax.random.PRNGKey(seed), cfg, jnp.float32))
    return cfg, tcfg, rp, _tensors(rp, "cpu")


def _x(shape, seed=1):
    return (np.random.default_rng(seed).standard_normal(shape) * 0.3).astype(np.float32)


def test_apply_moe_equals_exact_when_capacity_is_ample():
    cfg, tcfg, rp, tp = _moe(capacity_factor=8.0)
    x = torch.from_numpy(_x((2, 16, cfg.d_model)))
    cap, aux = TMOE.apply_moe(tp, tcfg, x)
    exact, aux_exact = TMOE.apply_moe_exact(tp, tcfg, x)
    torch.testing.assert_close(cap, exact, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(aux, aux_exact, rtol=1e-6, atol=0)
    _close(RMOE.apply_moe(rp, cfg, jnp.asarray(x.numpy()))[0], cap)


def test_apply_moe_drops_the_reference_tokens_when_overloaded():
    """capacity_factor 0.2: C = 7 slots an expert for 64 tokens x 2
    choices; the port keeps and drops the reference's assignments (its
    output equals the reference's) and so differs from the dropless form."""
    cfg, tcfg, rp, tp = _moe(capacity_factor=0.2)
    x = _x((2, 32, cfg.d_model))
    want, want_aux = RMOE.apply_moe(rp, cfg, jnp.asarray(x))
    got, aux = TMOE.apply_moe(tp, tcfg, torch.from_numpy(x))
    _close(want, got)
    _close(want_aux, aux)
    exact, _ = TMOE.apply_moe_exact(tp, tcfg, torch.from_numpy(x))
    assert not torch.allclose(got, exact, atol=1e-5)


@pytest.mark.parametrize("capacity_factor", [0.5, 1.25])
def test_apply_moe_matches_reference_across_padded_chunks(capacity_factor):
    """dispatch_chunk 16 over T = 2 x 23 = 46 tokens: three chunks, the last
    with 2 zero pad rows (routed, taking slots, in the last chunk's aux);
    output, aux (the chunks' mean) and the gradient of a weighted sum with
    respect to x and the router against the reference."""
    cfg, tcfg, rp, tp = _moe(capacity_factor=capacity_factor, dispatch_chunk=16)
    x = _x((2, 23, cfg.d_model), seed=3)
    cot = _x((2, 23, cfg.d_model), seed=4)

    def ref_obj(p, x):
        out, aux = RMOE.apply_moe(p, cfg, x)
        return jnp.sum(out * cot) + aux, (out, aux)

    (_, (want, want_aux)), (r_gp, r_gx) = jax.value_and_grad(
        ref_obj, argnums=(0, 1), has_aux=True)(rp, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    router = tp["router"].clone().requires_grad_()
    got, aux = TMOE.apply_moe(dict(tp, router=router), tcfg, tx)
    g_router, g_x = torch.autograd.grad(torch.sum(got * torch.from_numpy(cot)) + aux,
                                        (router, tx))
    _close(want, got)
    _close(want_aux, aux)
    _close(r_gx, g_x)
    _close(r_gp["router"], g_router)


def test_router_breaks_ties_as_the_reference():
    """A zero row gives every expert the same probability; jax.lax.top_k
    takes the lowest ids, and so must the port (torch.topk would not)."""
    cfg, tcfg, rp, tp = _moe()
    x = _x((6, cfg.d_model))
    x[[1, 4]] = 0.0
    _, r_idx, _ = RMOE._router(rp, cfg.moe, jnp.asarray(x))
    _, t_idx, _ = TMOE._router(tp, tcfg.moe, torch.from_numpy(x))
    np.testing.assert_array_equal(np.asarray(r_idx), t_idx.numpy())
    assert t_idx[1].tolist() == list(range(cfg.moe.top_k))
