"""State-space and recurrent sequence mixers (the reference's
``repro.models.ssm``): Mamba (Jamba's SSM), mLSTM and sLSTM (xLSTM).

Each mixer has an ``init_*``, a full-sequence ``apply_*``, an
``init_*_state`` and a one-token ``apply_*_step`` that returns the new state.
The reference has no Pallas kernel here, and neither has the port: these are
PyTorch operations on tensors, their dense products in ``torch.matmul`` /
``einsum``.

* Mamba's full-sequence scan runs chunk by chunk, carrying the state between
  chunks; inside a chunk the linear recurrence h_t = a_t h_{t-1} + b_t is a
  parallel prefix scan (log2(chunk) doubling steps), where the reference
  uses ``lax.associative_scan``.
* mLSTM's full sequence is the chunkwise linear-attention form
  (quadratic within a chunk, recurrent between chunks); its step is the
  stepwise recurrence.
* sLSTM is sequential by nature: a loop over time.

Every step function returns new state tensors and never writes into the
state it was given, so an engine's snapshot of an older state stays valid.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.mesh_ops import elementwise, merge_dims, split_dim
from repro_torch.models.layers import normal, rms_norm

_EPS = 1e-6


def _silu_gate(y: torch.Tensor, z: torch.Tensor, dtype) -> torch.Tensor:
    return (y * F.silu(z.float())).to(dtype)


# ======================================================================================
# Mamba
# ======================================================================================
def mamba_dims(cfg) -> Tuple[int, int, int]:
    """(d_inner, d_state, dt_rank)."""
    return cfg.ssm.expand * cfg.d_model, cfg.ssm.d_state, max(1, cfg.d_model // 16)


def init_mamba(gen: torch.Generator, cfg, dtype=torch.float32) -> dict:
    d = cfg.d_model
    d_in, N, dt_rank = mamba_dims(cfg)
    dc = cfg.ssm.d_conv
    dev = gen.device
    return {
        "in_proj": normal(gen, (d, 2 * d_in), 1.0 / math.sqrt(d), dtype),
        "conv_w": normal(gen, (dc, d_in), 1.0 / math.sqrt(dc), dtype),
        "conv_b": torch.zeros((d_in,), dtype=dtype, device=dev),
        "x_proj": normal(gen, (d_in, dt_rank + 2 * N), 1.0 / math.sqrt(d_in), dtype),
        "dt_proj": normal(gen, (dt_rank, d_in), 1.0 / math.sqrt(dt_rank), dtype),
        "dt_bias": torch.full((d_in,), -2.0, device=dev),       # softplus(-2) ~ 0.13
        "A_log": torch.log(torch.arange(1, N + 1, dtype=torch.float32, device=dev)
                           .repeat(d_in, 1)),
        "D": torch.ones((d_in,), device=dev),
        "out_proj": normal(gen, (d_in, d), 1.0 / math.sqrt(d_in), dtype),
    }


def _mamba_bcdt(p, cfg, u):
    """u (..., d_in), the conv'd and silu'd input -> (B, C, dt) per position."""
    _, N, dt_rank = mamba_dims(cfg)
    proj = (u @ p["x_proj"]).float()
    dt_r, Bm, Cm = torch.split(proj, [dt_rank, N, N], dim=-1)
    dt = F.softplus(dt_r @ p["dt_proj"].float() + p["dt_bias"])
    return Bm, Cm, dt


def _causal_conv(p, x_in, conv_state=None):
    """Depthwise causal conv. x_in (B, S, d_in); conv_state (B, dc - 1, d_in)
    holds the inputs before x_in (zeros at the start)."""
    dc = p["conv_w"].shape[0]
    if conv_state is None:
        pad = x_in.new_zeros((x_in.shape[0], dc - 1, x_in.shape[2]))
    else:
        pad = conv_state.to(x_in.dtype)
    xp = torch.cat([pad, x_in], dim=1)                      # (B, S + dc - 1, d_in)
    S = x_in.shape[1]
    out = sum(xp[:, i:i + S] * p["conv_w"][i] for i in range(dc))
    new_state = xp[:, xp.shape[1] - (dc - 1):] if dc > 1 else pad
    return out + p["conv_b"], new_state


def _linear_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive prefix scan of h_t = a_t h_{t-1} + b_t along dim 1 from
    h = 0, by doubling: returns (prod of a up to t, h_t)."""
    L, off = a.shape[1], 1
    while off < L:
        b = torch.cat([b[:, :off], torch.addcmul(b[:, off:], a[:, off:], b[:, :-off])], 1)
        a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], 1)
        off *= 2
    return a, b


def _mamba_inputs(p, cfg, x, conv_state=None):
    """x (B, S, d) -> (u, z, B, C, dt, new conv state)."""
    xz = x @ p["in_proj"]
    x_in, z = torch.chunk(xz, 2, dim=-1)
    x_c, new_conv = _causal_conv(p, x_in, conv_state)
    u = F.silu(x_c.float()).to(x.dtype)
    Bm, Cm, dt = _mamba_bcdt(p, cfg, u)
    return u, z, Bm, Cm, dt, new_conv


def apply_mamba(p, cfg, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence selective scan. x (B, S, d) -> (B, S, d)."""
    Bsz, S, _ = x.shape
    d_in, N, _ = mamba_dims(cfg)
    chunk = min(cfg.ssm.chunk, S)
    u, z, Bm, Cm, dt, _ = _mamba_inputs(p, cfg, x)
    A = -torch.exp(p["A_log"])                              # (d_in, N)
    uf = u.float()
    h = torch.zeros((Bsz, d_in, N), dtype=torch.float32, device=x.device)
    ys = []
    for c0 in range(0, S, chunk):
        sl = slice(c0, c0 + chunk)
        dtc = dt[:, sl]
        a = torch.exp(dtc[..., None] * A)                   # (B, L, d_in, N)
        b = (dtc * uf[:, sl])[..., None] * Bm[:, sl, None, :]
        a_sc, b_sc = _linear_scan(a, b)
        hs = a_sc * h[:, None] + b_sc
        ys.append(torch.einsum("blin,bln->bli", hs, Cm[:, sl]))
        h = hs[:, -1]
    y = torch.cat(ys, 1) + uf * p["D"]
    return _silu_gate(y, z, x.dtype) @ p["out_proj"]


def init_mamba_state(cfg, batch: int, device=None, dtype=torch.float32) -> dict:
    d_in, N, _ = mamba_dims(cfg)
    return {"h": torch.zeros((batch, d_in, N), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.ssm.d_conv - 1, d_in), dtype=dtype,
                                device=device)}


def apply_mamba_step(p, cfg, x: torch.Tensor, state: dict):
    """One decode step. x (B, 1, d) -> (out (B, 1, d), new state)."""
    u, z, Bm, Cm, dt, new_conv = _mamba_inputs(p, cfg, x, state["conv"])
    A = -torch.exp(p["A_log"])
    a = torch.exp(dt[:, 0, :, None] * A)                     # (B, d_in, N)
    b = (dt[:, 0] * u[:, 0].float())[..., None] * Bm[:, 0, None, :]
    h = a * state["h"] + b
    y = torch.einsum("bin,bn->bi", h, Cm[:, 0])[:, None] + u.float() * p["D"]
    return _silu_gate(y, z, x.dtype) @ p["out_proj"], {"h": h, "conv": new_conv}


def mamba_final_state(p, cfg, x: torch.Tensor) -> dict:
    """The state after stepping through x (B, S, d) from zeros: the
    per-token inputs of every step in one pass, then the recurrence token by
    token, as ``apply_mamba_step`` runs it."""
    u, _, Bm, _, dt, conv = _mamba_inputs(p, cfg, x)
    A = -torch.exp(p["A_log"])
    st = init_mamba_state(cfg, x.shape[0], x.device, x.dtype)
    h = st["h"]
    for t in range(x.shape[1]):
        a = torch.exp(dt[:, t, :, None] * A)
        h = a * h + (dt[:, t] * u[:, t].float())[..., None] * Bm[:, t, None, :]
    return {"h": h, "conv": conv}


# ======================================================================================
# mLSTM (xLSTM's matrix-memory block)
# ======================================================================================
def mlstm_dims(cfg) -> Tuple[int, int]:
    """(d_inner, per-head dim): proj factor 2, as in the xLSTM mLSTM block."""
    d_in = 2 * cfg.d_model
    return d_in, d_in // cfg.num_heads


def init_mlstm(gen: torch.Generator, cfg, dtype=torch.float32) -> dict:
    d = cfg.d_model
    d_in, _ = mlstm_dims(cfg)
    H = cfg.num_heads
    dev = gen.device
    sc, sci = 1.0 / math.sqrt(d), 1.0 / math.sqrt(d_in)
    return {
        "up_proj": normal(gen, (d, 2 * d_in), sc, dtype),
        "wq": normal(gen, (d_in, d_in), sci, dtype),
        "wk": normal(gen, (d_in, d_in), sci, dtype),
        "wv": normal(gen, (d_in, d_in), sci, dtype),
        "w_if": normal(gen, (d_in, 2 * H), sci, torch.float32),
        "b_i": torch.full((H,), -3.0, device=dev),
        "b_f": torch.full((H,), 3.0, device=dev),
        "norm": torch.ones((d_in,), dtype=dtype, device=dev),
        "down_proj": normal(gen, (d_in, d), sci, dtype),
    }


def _mlstm_qkvif(p, cfg, xu):
    """xu (B, S, d_in) -> q, k, v (B, S, H, hd), log f, log i (B, S, H)."""
    H = cfg.num_heads
    hd = xu.shape[-1] // H
    q = split_dim(xu @ p["wq"], 2, H)
    k = split_dim((xu @ p["wk"]) / math.sqrt(hd), 2, H)
    v = split_dim(xu @ p["wv"], 2, H)
    gi, gf = torch.chunk(xu.float() @ p["w_if"], 2, dim=-1)
    log_i = torch.clamp(gi + p["b_i"], -12.0, 4.0)           # capped exp input gate
    log_f = elementwise(F.logsigmoid, gf + p["b_f"])        # f in (0, 1)
    return q, k, v, log_f, log_i


def _mlstm_out(p, cfg, y, z, dtype):
    y = rms_norm(y.to(dtype), p["norm"], cfg.norm_eps)
    return (y * F.silu(z.float()).to(dtype)) @ p["down_proj"]


def apply_mlstm(p, cfg, x: torch.Tensor) -> torch.Tensor:
    """Chunkwise-parallel mLSTM. x (B, S, d) -> (B, S, d)."""
    B, S, _ = x.shape
    d_in, hd = mlstm_dims(cfg)
    H = cfg.num_heads
    chunk = min(cfg.ssm.chunk if cfg.ssm else 256, S)
    xu, z = torch.chunk(x @ p["up_proj"], 2, dim=-1)
    q, k, v, log_f, log_i = _mlstm_qkvif(p, cfg, xu)
    C = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=x.device)
    n = torch.zeros((B, H, hd), dtype=torch.float32, device=x.device)
    ys = []
    for c0 in range(0, S, chunk):
        sl = slice(c0, c0 + chunk)
        qb, kb, vb = q[:, sl].float(), k[:, sl].float(), v[:, sl].float()
        li = log_i[:, sl]
        cf = torch.cumsum(log_f[:, sl], dim=1)              # (B, L, H)
        L = qb.shape[1]
        qk = torch.einsum("bihd,bjhd->bhij", qb, kb)
        # w_ij = exp(cf_i - cf_j + li_j) for j <= i
        logw = (cf[:, :, None] - cf[:, None, :] + li[:, None, :]).permute(0, 3, 1, 2)
        causal = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
        a = qk * torch.where(causal, torch.exp(logw), torch.zeros((), device=x.device))
        inter = torch.exp(cf)                               # (B, L, H)
        y_intra = torch.einsum("bhij,bjhd->bihd", a, vb)
        y_inter = torch.einsum("bihd,bhde->bihe", qb, C) * inter[..., None]
        den = torch.abs(a.sum(-1) + torch.einsum("bihd,bhd->bhi", qb, n)
                        * inter.transpose(1, 2))            # (B, H, L)
        ys.append((y_intra + y_inter)
                  / torch.clamp(den.transpose(1, 2)[..., None], min=1.0))
        decay = torch.exp(cf[:, -1:] - cf + li)             # (B, L, H)
        last = torch.exp(cf[:, -1])                         # (B, H)
        C = last[..., None, None] * C + torch.einsum("bjh,bjhd,bjhe->bhde", decay, kb, vb)
        n = last[..., None] * n + torch.einsum("bjh,bjhd->bhd", decay, kb)
    y = merge_dims(torch.cat(ys, 1), 2, 3)
    return _mlstm_out(p, cfg, y, z, x.dtype)


def init_mlstm_state(cfg, batch: int, device=None, dtype=torch.float32) -> dict:
    _, hd = mlstm_dims(cfg)
    H = cfg.num_heads
    return {"C": torch.zeros((batch, H, hd, hd), dtype=torch.float32, device=device),
            "n": torch.zeros((batch, H, hd), dtype=torch.float32, device=device)}


def apply_mlstm_step(p, cfg, x: torch.Tensor, state: dict):
    """One decode step: the stepwise recurrence. x (B, 1, d)."""
    B = x.shape[0]
    d_in, _ = mlstm_dims(cfg)
    xu, z = torch.chunk(x @ p["up_proj"], 2, dim=-1)
    q, k, v, log_f, log_i = _mlstm_qkvif(p, cfg, xu)        # (B, 1, H, hd)
    f = torch.exp(log_f[:, 0])[..., None, None]             # (B, H, 1, 1)
    i = torch.exp(log_i[:, 0])[..., None, None]
    kf, vf = k[:, 0].float(), v[:, 0].float()
    C = f * state["C"] + i * torch.einsum("bhd,bhe->bhde", kf, vf)
    n = f[..., 0] * state["n"] + i[..., 0] * kf
    qf = q[:, 0].float()
    num = torch.einsum("bhd,bhde->bhe", qf, C)
    den = torch.abs(torch.einsum("bhd,bhd->bh", qf, n))
    y = (num / torch.clamp(den, min=1.0)[..., None]).reshape(B, 1, d_in)
    return _mlstm_out(p, cfg, y, z, x.dtype), {"C": C, "n": n}


def mlstm_final_state(p, cfg, x: torch.Tensor) -> dict:
    """The state after stepping through x (B, S, d) from zeros: gates, keys
    and values of every step in one pass, then the recurrence of
    ``apply_mlstm_step`` token by token."""
    xu, _ = torch.chunk(x @ p["up_proj"], 2, dim=-1)
    _, k, v, log_f, log_i = _mlstm_qkvif(p, cfg, xu)
    f, i = torch.exp(log_f), torch.exp(log_i)               # (B, S, H)
    st = init_mlstm_state(cfg, x.shape[0], x.device)
    C, n = st["C"], st["n"]
    for t in range(x.shape[1]):
        kf, vf = k[:, t].float(), v[:, t].float()
        ft, it = f[:, t, :, None], i[:, t, :, None]
        C = ft[..., None] * C + it[..., None] * (kf[..., :, None] * vf[..., None, :])
        n = ft * n + it * kf
    return {"C": C, "n": n}


# ======================================================================================
# sLSTM (xLSTM's scalar-memory block): sequential by nature
# ======================================================================================
def init_slstm(gen: torch.Generator, cfg, dtype=torch.float32) -> dict:
    d = cfg.d_model
    d_in = 2 * d
    H = cfg.num_heads
    hd = d_in // H
    dev = gen.device
    return {
        "up_proj": normal(gen, (d, 2 * d_in), 1.0 / math.sqrt(d), dtype),
        "w_gates": normal(gen, (d_in, 4 * d_in), 1.0 / math.sqrt(d_in), torch.float32),
        # block-diagonal recurrent weights: per head (hd, 4 * hd)
        "r_gates": normal(gen, (H, hd, 4 * hd), 1.0 / math.sqrt(hd), torch.float32),
        "b_gates": torch.cat([torch.full((d_in,), -3.0), torch.full((d_in,), 3.0),
                              torch.zeros((2 * d_in,))]).to(dev),
        "norm": torch.ones((d_in,), dtype=dtype, device=dev),
        "down_proj": normal(gen, (d_in, d), 1.0 / math.sqrt(d_in), dtype),
    }


def init_slstm_state(cfg, batch: int, device=None, dtype=torch.float32) -> dict:
    z = torch.zeros((batch, 2 * cfg.d_model), dtype=torch.float32, device=device)
    return {"c": z, "n": z + _EPS, "h": z, "m": z - 10.0}


def _slstm_cell(p, cfg, xw, st):
    """xw (B, 4 d_in): the step's input contribution; st: the state."""
    H = cfg.num_heads
    B, d4 = xw.shape
    rec = torch.einsum("bhk,hkj->bhj", split_dim(st["h"], 1, H), p["r_gates"])
    gates = xw + merge_dims(rec, 1, 2) + p["b_gates"]
    gi, gf, gz, go = torch.chunk(gates, 4, dim=-1)
    # stabilised exponential gating (xLSTM eq. 15-17)
    log_f = elementwise(F.logsigmoid, gf)
    gi = torch.clamp(gi, -12.0, 8.0)
    m_new = torch.maximum(log_f + st["m"], gi)
    i = torch.exp(gi - m_new)
    f = torch.exp(log_f + st["m"] - m_new)
    c = f * st["c"] + i * torch.tanh(gz)
    n = f * st["n"] + i
    h = torch.sigmoid(go) * c / torch.clamp(n, min=_EPS)
    return {"c": c, "n": n, "h": h, "m": m_new}


def _slstm_run(p, cfg, x: torch.Tensor):
    """x (B, S, d) -> (the hidden states (B, S, d_in), the final state, the
    output gate's input z)."""
    xu, z = torch.chunk(x @ p["up_proj"], 2, dim=-1)
    xw = xu.float() @ p["w_gates"]
    st = init_slstm_state(cfg, x.shape[0], x.device)
    hs = []
    for t in range(x.shape[1]):
        st = _slstm_cell(p, cfg, xw[:, t], st)
        hs.append(st["h"])
    return torch.stack(hs, 1), st, z


def _slstm_out(p, cfg, y, z, dtype):
    y = rms_norm(y.to(dtype), p["norm"], cfg.norm_eps)
    return (y * F.silu(z.float()).to(dtype)) @ p["down_proj"]


def apply_slstm(p, cfg, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence sLSTM, a loop over time. x (B, S, d) -> (B, S, d)."""
    hs, _, z = _slstm_run(p, cfg, x)
    return _slstm_out(p, cfg, hs, z, x.dtype)


def apply_slstm_step(p, cfg, x: torch.Tensor, state: dict):
    """One decode step. x (B, 1, d)."""
    xu, z = torch.chunk(x @ p["up_proj"], 2, dim=-1)
    st = _slstm_cell(p, cfg, (xu.float() @ p["w_gates"])[:, 0], state)
    return _slstm_out(p, cfg, st["h"][:, None], z, x.dtype), st


def slstm_final_state(p, cfg, x: torch.Tensor) -> dict:
    """The state after stepping through x (B, S, d) from zeros."""
    return _slstm_run(p, cfg, x)[1]
