"""Mixture-of-experts FFN (the reference's ``repro.models.moe``): ``init_moe``,
``_router``, the dropless ``apply_moe_exact`` that serving runs, and the
capacity dispatch ``apply_moe`` that ``Model.forward`` (training) runs.

``apply_moe_exact`` computes every expert for every token and weights the
results by the router's renormalised top-k probabilities, so a token's output
does not depend on which other tokens share its batch: prefill, decode and a
re-decode after rollback agree. It reads every expert's weights on each call
(O(T * E) work), which is what the serving path pays.

``apply_moe`` cuts the tokens into chunks of ``dispatch_chunk`` (the last
padded with zero rows, which are routed like any token) and gives each
expert C = ceil(Tc * k / E * capacity_factor) slots per chunk; an assignment
past its expert's C is dropped. Which ones drop depends on the chunking and
on the flat (token, choice) order, so both follow the reference exactly.

Expert weights are stacked ``(E, d, f)`` / ``(E, f, d)`` as in the
reference, and the dense products go to ``torch.matmul``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.distributed.mesh_ops import shard
from repro_torch.distributed.sharding import Spec


def _normal(gen, shape, scale, dtype):
    return (torch.randn(shape, generator=gen, device=gen.device,
                        dtype=torch.float32) * scale).to(dtype)


def init_moe(gen: torch.Generator, cfg, dtype=torch.float32) -> dict:
    """Random MoE parameters with the reference's shapes and scales: the
    router (d, E) in fp32, the stacked experts, and the shared experts as
    one SwiGLU of width ``d_expert * num_shared_experts``."""
    m = cfg.moe
    d, f, E = cfg.d_model, m.d_expert, m.num_experts
    sc_in, sc_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
    p = {"router": _normal(gen, (d, E), sc_in, torch.float32),
         "w_gate": _normal(gen, (E, d, f), sc_in, dtype),
         "w_up": _normal(gen, (E, d, f), sc_in, dtype),
         "w_down": _normal(gen, (E, f, d), sc_out, dtype)}
    if m.num_shared_experts:
        fs = f * m.num_shared_experts
        p["shared"] = {"w_gate": _normal(gen, (d, fs), sc_in, dtype),
                       "w_up": _normal(gen, (d, fs), sc_in, dtype),
                       "w_down": _normal(gen, (fs, d), sc_out, dtype)}
    return p


def _router(p: dict, m, x2d: torch.Tensor):
    """x2d (T, d) -> (weights (T, k), expert ids (T, k), aux loss): softmax
    over the experts, top k, weights renormalised to sum to 1. The aux loss
    (load balance + router z-loss) is the training objective's term."""
    logits = x2d.float() @ p["router"]
    probs = torch.softmax(logits, dim=-1)
    # jax.lax.top_k puts the lower expert first among equal probabilities
    # (a zero pad row ties them all); torch.topk promises no order, so sort
    topw, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topw, topi = topw[:, :m.top_k], topi[:, :m.top_k]
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)
    E = probs.shape[-1]
    me = probs.mean(0)
    # the reference averages the first choices' counts over the experts too,
    # so ce is a scalar
    ce = (F.one_hot(topi[:, 0], E).float().sum(0) / max(probs.shape[0], 1)).mean()
    lb = E * torch.sum(me * ce)
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return topw, topi, m.load_balance_loss * lb + m.router_z_loss * z


def _swiglu(x, w_gate, w_up, w_down):
    h = F.silu((x @ w_gate).float()).to(x.dtype) * (x @ w_up)
    return h @ w_down


def apply_moe_exact(p: dict, cfg, x: torch.Tensor):
    """x (B, S, d) -> (out (B, S, d), aux loss). Every expert runs on every
    token; the (T, E) weight matrix holds each token's top-k weights and
    zeros elsewhere. The shared experts are added to every token."""
    m = cfg.moe
    B, S, d = x.shape
    x2d = x.reshape(B * S, d)
    topw, topi, aux = _router(p, m, x2d)
    wmat = torch.zeros((B * S, m.num_experts), dtype=torch.float32, device=x.device)
    wmat = wmat.scatter(1, topi, topw)
    o = _swiglu(x2d, p["w_gate"], p["w_up"], p["w_down"])         # (E, T, d)
    out = torch.einsum("etd,te->td", o.float(), wmat).reshape(B, S, d).to(x.dtype)
    if m.num_shared_experts:
        sp = p["shared"]
        out = out + _swiglu(x, sp["w_gate"], sp["w_up"], sp["w_down"])
    return out, aux


def _dispatch_chunk(p: dict, m, xc: torch.Tensor):
    """One chunk (Tc, d) -> (routed-expert output (Tc, d), aux loss), the
    reference's scatter/gather: assignment a = (t, j) in flat order goes to
    slot pos_a of expert e_a, pos_a counting the earlier assignments to e_a;
    slots >= C are dropped (the reference scatters them out of bounds with
    ``mode="drop"``). Dropped assignments scatter into a trash row past the
    (E * C) buffer, which no expert reads, and gather zeros back, so the
    pass needs no host sync and writes into no tensor autograd holds."""
    Tc, d = xc.shape
    E, k = m.num_experts, m.top_k
    C = max(1, int(math.ceil(Tc * k / E * m.capacity_factor)))
    topw, topi, aux = _router(p, m, xc)
    flat_e = topi.reshape(-1)                                   # (Tc * k,)
    onehot = F.one_hot(flat_e, E)
    pos = ((torch.cumsum(onehot, 0) - onehot) * onehot).sum(-1)
    keep = pos < C
    slot = torch.where(keep, flat_e * C + pos, E * C)            # E * C: the trash row
    src = xc.repeat_interleave(k, dim=0)                        # row t*k + j is token t
    buf = xc.new_zeros((E * C + 1, d)).index_copy(0, slot, src)[:E * C]
    # experts over 'model' (E -> 'model', f -> 'data'): the dispatch buffer
    # keeps d whole, so the e, d -> f contraction is local, as in the reference
    buf = shard(buf.reshape(E, C, d), Spec("model", None, None))
    out_buf = shard(_swiglu(buf, p["w_gate"], p["w_up"], p["w_down"]),
                    Spec("model", None, None))
    gathered = torch.cat([out_buf.reshape(E * C, d), out_buf.new_zeros((1, d))])[slot]
    w = (topw.reshape(-1) * keep).float()[:, None]
    out = (gathered.float() * w).reshape(Tc, k, d).sum(1)
    return out.to(xc.dtype), aux


def apply_moe(p: dict, cfg, x: torch.Tensor):
    """x (B, S, d) -> (out, aux loss): the capacity MoE over chunks of
    ``dispatch_chunk`` tokens (the last zero-padded), aux the mean of the
    chunks' (the pad rows' routing included), and the shared experts added
    to every token outside the chunks, as the reference does."""
    m = cfg.moe
    B, S, d = x.shape
    T = B * S
    chunk = min(m.dispatch_chunk, T)
    n = -(-T // chunk)
    xs = F.pad(x.reshape(T, d), (0, 0, 0, n * chunk - T))
    outs, auxs = zip(*(_dispatch_chunk(p, m, xc) for xc in xs.split(chunk)))
    out = torch.cat(outs)[:T].reshape(B, S, d)
    aux = torch.stack(auxs).mean()
    if m.num_shared_experts:
        sp = p["shared"]
        out = out + _swiglu(x, sp["w_gate"], sp["w_up"], sp["w_down"])
    return out, aux
