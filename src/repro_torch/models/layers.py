"""Building blocks of the dense decoder, as plain functions over parameter
dicts (the reference's ``repro.models.layers``, dense subset).

Weights keep the reference layout, ``(d_in, d_out)``, so ``x @ w`` here is the
reference's ``einsum("...d,df->...f")``. Attention goes through the kernel
wrappers: :func:`repro_torch.kernels.prefill_attention.prefill_attention` on
the full sequence and :func:`repro_torch.kernels.decode_attention.decode_attention`
on one decode step; each runs its CUDA kernel on the card and its plain
version on the CPU.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.prefill_attention import prefill_attention


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * scale.float()).to(dt)


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """(cos, sin) of the rotation at ``positions`` (..., S), each
    (..., S, 1, hd/2). A forward pass computes them once and every layer's q
    and k reuse them (or None when the model has no rope)."""
    if theta <= 0:
        return None
    freqs = rope_frequencies(head_dim, theta, positions.device)
    angles = positions[..., None].float() * freqs              # (..., S, hd/2)
    return torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]


def rotate(x: torch.Tensor, rope) -> torch.Tensor:
    """Split-half rotation of x (..., S, H, hd), as in the reference."""
    if rope is None:
        return x
    cos, sin = rope
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions broadcastable to (..., S)."""
    return rotate(x, rope_tables(positions, x.shape[-1], theta))


def apply_mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: (silu(x W_gate) * x W_up) W_down."""
    g = x @ p["w_gate"]
    u = x @ p["w_up"]
    h = F.silu(g.float()).to(x.dtype) * u
    return h @ p["w_down"]


def _project_qkv(p: dict, cfg, xq: torch.Tensor, xkv: torch.Tensor):
    B, S = xq.shape[0], xq.shape[1]
    T = xkv.shape[1]
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = xq @ p["wq"]
    k = xkv @ p["wk"]
    v = xkv @ p["wv"]
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, T, KV, hd)
    v = v.reshape(B, T, KV, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def self_attention_qkv(p: dict, cfg, x: torch.Tensor, rope):
    """Projected, roped q/k and v of a full sequence (``rope`` from
    :func:`rope_tables`) — k and v are also what prefill hands to the decode
    cache."""
    q, k, v = _project_qkv(p, cfg, x, x)
    return rotate(q, rope), rotate(k, rope), v


def attend_full(p: dict, q, k, v, *, causal=True, window=0, prefix_len=0):
    """Full-sequence attention through the prefill kernel, then W_o. One
    kernel stands for the reference's plain and blockwise forms alike."""
    B, S = q.shape[0], q.shape[1]
    out = prefill_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                            causal=causal, window=window, prefix_len=prefix_len)
    return out.reshape(B, S, -1) @ p["wo"]


def decode_positions(position, batch: int, device) -> torch.Tensor:
    """(B, 1) positions of one decode step from an int or a (B,) tensor."""
    if isinstance(position, torch.Tensor):
        return position.to(device).reshape(-1, 1).expand(batch, 1)
    return torch.full((batch, 1), int(position), device=device)


def apply_self_attention_decode(p: dict, cfg, x, position, k_cache, v_cache,
                                cache_len, write_idx, rope=None) -> tuple:
    """One-token decode: project, rope at ``position`` (or the step's
    precomputed ``rope`` tables), write the ring slot, attend through the
    decode kernel. Returns (out, new_k_cache, new_v_cache).

    The ring write is functional, as in the reference: it builds new cache
    tensors and never touches ``k_cache``/``v_cache``, so every engine
    snapshot that holds the old tensors stays valid. ``write_idx`` is an int
    (one slot for the whole batch) or a (B,) tensor of per-slot ring indices;
    ``cache_len`` is a (B,) int32 tensor."""
    B = x.shape[0]
    q, k, v = _project_qkv(p, cfg, x, x)                       # S == 1
    if rope is None:
        rope = rope_tables(decode_positions(position, B, x.device),
                           cfg.head_dim, cfg.rope_theta)
    q, k = rotate(q, rope), rotate(k, rope)
    k_cache = k_cache.clone()
    v_cache = v_cache.clone()
    if isinstance(write_idx, torch.Tensor):
        rows = torch.arange(B, device=x.device)
        k_cache[rows, write_idx.long()] = k[:, 0].to(k_cache.dtype)
        v_cache[rows, write_idx.long()] = v[:, 0].to(v_cache.dtype)
    else:
        k_cache[:, write_idx] = k[:, 0].to(k_cache.dtype)
        v_cache[:, write_idx] = v[:, 0].to(v_cache.dtype)
    out = decode_attention(q[:, 0].contiguous(), k_cache, v_cache, cache_len)
    return out.reshape(B, 1, -1) @ p["wo"], k_cache, v_cache
