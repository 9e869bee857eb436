"""Building blocks of the models, as plain functions over parameter dicts
(the reference's ``repro.models.layers``): norms, rope and sinusoidal
positions, the SwiGLU MLP, self-attention, and the audio decoder's
cross-attention over its encoder's memory.

Weights keep the reference layout, ``(d_in, d_out)``, so ``x @ w`` here is the
reference's ``einsum("...d,df->...f")``. Serving attention goes through the
kernel wrappers: :func:`repro_torch.kernels.prefill_attention.prefill_attention`
on the full sequence (:func:`attend_full`) and
:func:`repro_torch.kernels.decode_attention.decode_attention` on one decode
step; each runs its CUDA kernel on the card and its plain version on the CPU.
The kernels have no backward, so training goes another route:
:func:`apply_self_attention` over :func:`plain_attention` and
:func:`blockwise_attention`, PyTorch copies of the reference's jnp training
attention that autograd differentiates on either device. The caller picks the
route (``Model.forward(differentiable=...)``); a kernel wrapper handed a
tensor that requires grad raises. Cross-attention is plain PyTorch on both,
as the reference's is plain jnp outside any Pallas kernel.

Activation constraints: ``shard`` (``distributed.mesh_ops``) is the
reference's ``shard``, at the reference's call sites here, in ``model`` and
in ``moe``. On a DTensor it redistributes the activation to a spec's
placements on the tensor's own mesh, so a step run as DTensors
(``launch.dryrun``) moves its activations where the reference's partitioner
is told to; on a plain tensor it is the identity, as is every other
``mesh_ops`` helper, so serving, training and every single-device run are
untouched.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from repro_torch.distributed.mesh_ops import (BATCH, kv_for_mesh, merge_dims, mesh_active,
                                              shard, split_dim)
# the reference's layers.batch_axes
from repro_torch.distributed.sharding import Spec, batch_axes  # noqa: F401
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.prefill_attention import prefill_attention

def normal(gen: torch.Generator, shape, scale: float, dtype=torch.float32) -> torch.Tensor:
    """Normal draws times ``scale`` on the generator's device: the reference's
    ``jax.random.normal(...) * scale`` init (other numbers from the same
    seed)."""
    return (torch.randn(shape, generator=gen, device=gen.device,
                        dtype=torch.float32) * scale).to(dtype)


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, dtype=torch.float32) -> dict:
    return {"w_gate": normal(gen, (d_model, d_ff), 1.0 / math.sqrt(d_model), dtype),
            "w_up": normal(gen, (d_model, d_ff), 1.0 / math.sqrt(d_model), dtype),
            "w_down": normal(gen, (d_ff, d_model), 1.0 / math.sqrt(d_ff), dtype)}


def init_attention(gen: torch.Generator, cfg, dtype=torch.float32,
                   cross: bool = False) -> dict:
    """Self-attention's parameters, or (``cross``) a decoder's
    cross-attention's, which has the same leaves: q from the decoder, k and
    v from the encoder's memory."""
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dev = gen.device
    p = {"wq": normal(gen, (d, H * hd), 1.0 / math.sqrt(d), dtype),
         "wk": normal(gen, (d, KV * hd), 1.0 / math.sqrt(d), dtype),
         "wv": normal(gen, (d, KV * hd), 1.0 / math.sqrt(d), dtype),
         "wo": normal(gen, (H * hd, d), 1.0 / math.sqrt(H * hd), dtype)}
    if cfg.qkv_bias:
        p.update(bq=torch.zeros((H * hd,), dtype=dtype, device=dev),
                 bk=torch.zeros((KV * hd,), dtype=dtype, device=dev),
                 bv=torch.zeros((KV * hd,), dtype=dtype, device=dev))
    if cfg.qk_norm:
        p.update(q_norm=torch.ones((hd,), dtype=dtype, device=dev),
                 k_norm=torch.ones((hd,), dtype=dtype, device=dev))
    return p


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


def sinusoid_at(positions: torch.Tensor, d_model: int) -> torch.Tensor:
    """Whisper-style fixed sinusoidal embeddings (models with rope_theta <=
    0) at ``positions`` (...,) -> (..., d_model): sines, then cosines."""
    dim = torch.arange(d_model // 2, dtype=torch.float32, device=positions.device)
    inv = torch.exp(-math.log(10000.0) * dim / max(d_model // 2 - 1, 1))
    ang = positions.float()[..., None] * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def sinusoidal_positions(seq_len: int, d_model: int, device=None) -> torch.Tensor:
    """(seq_len, d_model) embeddings of positions 0 .. seq_len - 1."""
    return sinusoid_at(torch.arange(seq_len, device=device), d_model)


def apply_mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: (silu(x W_gate) * x W_up) W_down."""
    g = x @ p["w_gate"]
    u = x @ p["w_up"]
    h = shard(F.silu(g.float()).to(x.dtype) * u, Spec(BATCH, None, "model"))
    return h @ p["w_down"]


def _project_qkv(p: dict, cfg, xq: torch.Tensor, xkv: torch.Tensor):
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = xq @ p["wq"]
    k = xkv @ p["wk"]
    v = xkv @ p["wv"]
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q, k, v = split_dim(q, 2, H), split_dim(k, 2, KV), split_dim(v, 2, KV)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def self_attention_qkv(p: dict, cfg, x: torch.Tensor, rope):
    """Projected, roped q/k and v of a full sequence (``rope`` from
    :func:`rope_tables`) — k and v are also what prefill hands to the decode
    cache."""
    q, k, v = _project_qkv(p, cfg, x, x)
    heads = Spec(BATCH, None, "model", None)
    return shard(rotate(q, rope), heads), shard(rotate(k, rope), heads), v


_NEG_INF = -1e30


def _mask_block(qi, kj, *, causal: bool, window: int, prefix_len: int,
                valid_len=None) -> torch.Tensor:
    """(bq, bk) boolean allowed-mask for global query positions qi (bq,) and
    key positions kj (bk,): the reference's ``layers._mask_block``."""
    qi_, kj_ = qi[:, None], kj[None, :]
    allowed = torch.ones((qi.shape[0], kj.shape[0]), dtype=torch.bool, device=qi.device)
    if causal:
        c = kj_ <= qi_
        if prefix_len > 0:
            c = c | ((qi_ < prefix_len) & (kj_ < prefix_len))
        allowed = allowed & c
    if window > 0:
        allowed = allowed & (kj_ > qi_ - window)
    if valid_len is not None:
        allowed = allowed & (kj_ < valid_len)
    return allowed


def plain_attention(q, k, v, *, causal=True, window=0, prefix_len=0, scale=None):
    """The reference's ``plain_attention``: q (B, S, H, hd), k/v (B, T, KV,
    hd) -> (B, S, H, hd) through the full (S, T) score matrix, differentiable
    (k, v through ``mesh_ops.kv_for_mesh``)."""
    k, v = kv_for_mesh(q, k, v)
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qg = q.float().reshape(B, S, KV, H // KV, hd)
    s = torch.einsum("bqkgh,btkh->bqkgt", qg, k.float()) * scale
    msk = _mask_block(torch.arange(S, device=q.device), torch.arange(T, device=q.device),
                      causal=causal, window=window, prefix_len=prefix_len)
    s = s.masked_fill(~msk[None, :, None, None, :], _NEG_INF)
    out = torch.einsum("bqkgt,btkh->bqkgh", torch.softmax(s, dim=-1), v.float())
    return out.reshape(B, S, H, hd).to(q.dtype)


def blockwise_attention(q, k, v, *, causal=True, window=0, prefix_len=0,
                        q_chunk=1024, kv_chunk=1024, scale=None):
    """The reference's ``blockwise_attention``: online softmax over
    ``kv_chunk`` keys at a time for each ``q_chunk`` of queries, so no (S, T)
    score matrix is built. Causal chunks wholly above the diagonal (or, with
    a ``window``, wholly before it) are skipped, not masked, by the
    reference's static per-chunk bounds, so the work is ~S^2/2. S and T are
    zero-padded to their chunk multiples and the padded keys masked (k, v
    through ``mesh_ops.kv_for_mesh``)."""
    k, v = kv_for_mesh(q, k, v)
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    q_chunk, kv_chunk = min(q_chunk, S), min(kv_chunk, T)
    n_q, n_kv = -(-S // q_chunk), -(-T // kv_chunk)
    q = F.pad(q, (0, 0, 0, 0, 0, n_q * q_chunk - S))
    k = F.pad(k, (0, 0, 0, 0, 0, n_kv * kv_chunk - T))
    v = F.pad(v, (0, 0, 0, 0, 0, n_kv * kv_chunk - T))
    qg = q.float().reshape(B, n_q, q_chunk, KV, G, hd)
    kg = k.float().reshape(B, n_kv, kv_chunk, KV, hd)
    vg = v.float().reshape(B, n_kv, kv_chunk, KV, hd)
    dev = q.device
    outs = []
    for qi in range(n_q):
        q_blk = qg[:, qi]                                      # (B, bq, KV, G, hd)
        q_idx = qi * q_chunk + torch.arange(q_chunk, device=dev)
        acc = torch.zeros((B, q_chunk, KV, G, hd), dtype=torch.float32, device=dev)
        m = torch.full((B, q_chunk, KV, G), _NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((B, q_chunk, KV, G), dtype=torch.float32, device=dev)
        hi = min(n_kv, ((qi + 1) * q_chunk - 1) // kv_chunk + 1) if causal else n_kv
        lo = max(0, (qi * q_chunk - window) // kv_chunk) if causal and window > 0 else 0
        for kj in range(lo, hi):
            k_idx = kj * kv_chunk + torch.arange(kv_chunk, device=dev)
            s = torch.einsum("bqkgh,btkh->bkgqt", q_blk, kg[:, kj]) * scale
            msk = _mask_block(q_idx, k_idx, causal=causal, window=window,
                              prefix_len=prefix_len, valid_len=T)
            s = s.masked_fill(~msk, _NEG_INF).permute(0, 3, 1, 2, 4)  # (B, bq, KV, G, bk)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum("bqkgt,btkh->bqkgh", p, vg[:, kj])
            m = m_new
        outs.append((acc / torch.clamp(l[..., None], min=1e-30)).to(q.dtype))
    out = torch.stack(outs, 1).reshape(B, n_q * q_chunk, H, hd)
    return out[:, :S]


def apply_self_attention(p: dict, cfg, x: torch.Tensor, positions: torch.Tensor, *,
                         causal=True, window=0, prefix_len=0, q_chunk=1024,
                         kv_chunk=1024) -> torch.Tensor:
    """Full-sequence self-attention on the differentiable route (the
    reference's ``apply_self_attention``, what training runs): project, rope
    at ``positions`` (1, S), then :func:`plain_attention` up to S =
    max(q_chunk, 2048) and :func:`blockwise_attention` above, then W_o."""
    q, k, v = self_attention_qkv(p, cfg, x, rope_tables(positions, cfg.head_dim,
                                                        cfg.rope_theta))
    S = x.shape[1]
    kw = dict(causal=causal, window=window, prefix_len=prefix_len)
    if S <= max(q_chunk, 2048):
        out = plain_attention(q, k, v, **kw)
    else:
        out = blockwise_attention(q, k, v, q_chunk=q_chunk, kv_chunk=kv_chunk, **kw)
    return merge_dims(out, 2, 3) @ p["wo"]


def attend_full(p: dict, q, k, v, *, causal=True, window=0, prefix_len=0):
    """Full-sequence attention through the prefill kernel, then W_o. One
    kernel stands for the reference's plain and blockwise forms alike;
    ``prefix_len`` > 0 lets the first positions (a VLM's image patches)
    attend to each other both ways, the prefix-LM mask."""
    B, S = q.shape[0], q.shape[1]
    out = prefill_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                            causal=causal, window=window, prefix_len=prefix_len)
    return out.reshape(B, S, -1) @ p["wo"]


def apply_cross_attention(p: dict, cfg, x: torch.Tensor, mem_k: torch.Tensor,
                          mem_v: torch.Tensor) -> torch.Tensor:
    """Decoder cross-attention over the encoder memory's projected K/V (B, T,
    KV, hd): every query attends to every frame (no mask), GQA, then W_o."""
    B, S = x.shape[0], x.shape[1]
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = x @ p["wq"]
    if cfg.qkv_bias:
        q = q + p["bq"]
    q = split_dim(q.float(), 2, KV).reshape(B, S, KV, H // KV, hd)
    s = torch.einsum("bqkgh,btkh->bqkgt", q, mem_k.float()) / math.sqrt(hd)
    out = torch.einsum("bqkgt,btkh->bqkgh", torch.softmax(s, dim=-1), mem_v.float())
    # one 2-D product, the one the plain (B, S, H * hd) @ W_o folds to: on a
    # DTensor, whose propagated strides of the size-1 query dim may differ,
    # matmul would not fold and would round differently
    out = merge_dims(out, 2, 4).reshape(B * S, -1)
    return (out.to(x.dtype) @ p["wo"]).reshape(B, S, -1)


def project_memory_kv(p: dict, cfg, mem: torch.Tensor):
    """The encoder output (B, T, d) projected once into the decoder's
    cross-attention K/V, each (B, T, KV, hd)."""
    B, T = mem.shape[0], mem.shape[1]
    KV, hd = cfg.num_kv_heads, cfg.head_dim
    k = mem @ p["wk"]
    v = mem @ p["wv"]
    if cfg.qkv_bias:
        k = k + p["bk"]
        v = v + p["bv"]
    return split_dim(k, 2, KV), split_dim(v, 2, KV)


def decode_positions(position, batch: int, device) -> torch.Tensor:
    """(B, 1) positions of one decode step from an int or a (B,) tensor."""
    if isinstance(position, torch.Tensor):
        return position.to(device).reshape(-1, 1).expand(batch, 1)
    return torch.full((batch, 1), int(position), device=device)


def apply_self_attention_decode(p: dict, cfg, x, position, k_cache, v_cache,
                                cache_len, write_idx, rope=None, inplace=False) -> tuple:
    """One-token decode: project, rope at ``position`` (or the step's
    precomputed ``rope`` tables), write the ring slot, attend through the
    decode kernel. Returns (out, new_k_cache, new_v_cache).

    The ring write is functional, as in the reference: it builds new cache
    tensors and never touches ``k_cache``/``v_cache``, so every engine
    snapshot that holds the old tensors stays valid. ``write_idx`` is an int
    (one slot for the whole batch) or a (B,) tensor of per-slot ring indices;
    ``cache_len`` is a (B,) int32 tensor.

    On a mesh (``mesh_active``: a DTensor cache, its window perhaps
    split over 'model') the write is the reference's masked ``where`` over
    the window: an indexed write into a split window would make the
    partitioner gather the whole cache (the reference measured 56 GB a step
    on kimi x decode_32k), and DTensor has no indexed write into a DTensor
    at all. Elsewhere it is the indexed write into a clone, or with
    ``inplace`` into ``k_cache``/``v_cache`` themselves: the static buffers
    of a captured decode step (``models.model.DecodeGraph``), which owns
    them."""
    B = x.shape[0]
    q, k, v = _project_qkv(p, cfg, x, x)                       # S == 1
    if rope is None:
        rope = rope_tables(decode_positions(position, B, x.device),
                           cfg.head_dim, cfg.rope_theta)
    q, k = rotate(q, rope), rotate(k, rope)
    if mesh_active(k_cache):
        idx = torch.as_tensor(write_idx, device=x.device).reshape(-1, 1, 1, 1)
        slot = torch.arange(k_cache.shape[1], device=x.device)[None, :, None, None] == idx
        k_cache = torch.where(slot, k.to(k_cache.dtype), k_cache)
        v_cache = torch.where(slot, v.to(v_cache.dtype), v_cache)
    else:
        if not inplace:
            k_cache, v_cache = k_cache.clone(), v_cache.clone()
        if isinstance(write_idx, torch.Tensor):
            rows = torch.arange(B, device=x.device)
            k_cache[rows, write_idx.long()] = k[:, 0].to(k_cache.dtype)
            v_cache[rows, write_idx.long()] = v[:, 0].to(v_cache.dtype)
        else:
            k_cache[:, write_idx] = k[:, 0].to(k_cache.dtype)
            v_cache[:, write_idx] = v[:, 0].to(v_cache.dtype)
    out = decode_attention(q[:, 0].contiguous(), k_cache, v_cache, cache_len)
    return out.reshape(B, 1, -1) @ p["wo"], k_cache, v_cache
