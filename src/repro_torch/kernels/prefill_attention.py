"""B3: blockwise (flash) attention for prefill (``csrc/prefill_attention.cu``).

Counterpart of ``repro.kernels.prefill_attention.prefill_attention_pallas``,
and on the card of the reference model's ``plain_attention`` /
``blockwise_attention``: q (B, S, H, hd), k/v (B, S, KV, hd) -> (B, S, H, hd);
causal (optionally with a bidirectional prefix of ``prefix_len`` positions),
optional sliding ``window``, GQA.

:func:`prefill_attention` runs the CUDA kernel on CUDA tensors, at any hd
(built for the same widths as B2, ``decode_attention.HEAD_DIMS``, any other
hd up to 256 zero-padded to the next of them with the real hd's softmax
scale; above 256 a separate wide-head kernel takes hd zero-padded to a
multiple of 4), and :func:`prefill_attention_plain` on CPU tensors.
``launches`` counts kernel launches. DTensor inputs go through
``mesh_ops.on_mesh`` as B2's do (:data:`MESH_RULES`). The kernel has no
backward: the wrapper
raises on inputs that require grad under grad mode, on either device
(training attends through ``models.layers.apply_self_attention``).
"""
from __future__ import annotations

import ctypes
import math

import torch

from torch.distributed.tensor import Replicate, Shard

from repro_torch.distributed import mesh_ops
from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import instance_hd, pad_hd

launches = 0
# on one mesh dim, the placements of (q, k, v) under which each rank attends
# its shards alone, and the output's: all whole, the batch split, or the
# heads split (query heads with their KV heads)
MESH_RULES = (((Replicate(),) * 3, Replicate()),
              ((Shard(0),) * 3, Shard(0)),
              ((Shard(2),) * 3, Shard(2)))


def allowed_mask(S: int, T: int, *, causal: bool, window: int, prefix_len: int,
                 device=None) -> torch.Tensor:
    """(S, T) boolean: which keys each query may attend to (the reference's
    ``layers._mask_block`` without the ragged valid-length term)."""
    qi = torch.arange(S, device=device)[:, None]
    kj = torch.arange(T, device=device)[None, :]
    allowed = torch.ones((S, T), dtype=torch.bool, device=device)
    if causal:
        c = kj <= qi
        if prefix_len > 0:
            c = c | ((qi < prefix_len) & (kj < prefix_len))
        allowed &= c
    if window > 0:
        allowed &= kj > qi - window
    return allowed


def prefill_attention_plain(q, k, v, *, causal=True, window=0, prefix_len=0):
    """The reference's plain_attention: the full (S, T) score matrix (k, v
    through ``mesh_ops.kv_for_mesh``)."""
    k, v = mesh_ops.kv_for_mesh(q, k, v)
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.float().reshape(B, S, KV, G, hd)
    s = torch.einsum("bqkgh,btkh->bqkgt", qg, k.float()) / math.sqrt(hd)
    msk = allowed_mask(S, T, causal=causal, window=window,
                       prefix_len=prefix_len, device=q.device)
    s = torch.where(msk[None, :, None, None, :], s,
                    torch.tensor(-1e30, device=q.device))
    p = mesh_ops.softmax_last(s)
    out = torch.einsum("bqkgt,btkh->bqkgh", p, v.float())
    return out.reshape(B, S, H, hd).to(q.dtype)


_fn = None


def _launch_fn():
    global _fn
    if _fn is None:
        fn = _build.library("prefill_attention").prefill_attention_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, ctypes.c_float, p]
        fn.restype = i
        _fn = fn
    return _fn


def prefill_attention(q, k, v, *, causal: bool = True, window: int = 0,
                      prefix_len: int = 0):
    """q (B, S, H, hd); k/v (B, S, KV, hd) -> (B, S, H, hd)."""
    B, S, H, hd = q.shape
    if k.shape != v.shape or k.ndim != 4 or k.shape[:2] != (B, S) \
            or k.shape[3] != hd or H % k.shape[2]:
        raise ValueError(f"prefill_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    _build.refuse_grad("prefill_attention", q, k, v)
    kw = dict(causal=causal, window=window, prefix_len=prefix_len)
    if mesh_ops.is_distributed(q, k, v):
        return mesh_ops.on_mesh("prefill_attention",
                                lambda *a: _kernel(*a, **kw),
                                lambda *a: prefill_attention_plain(*a, **kw), (q, k, v),
                                MESH_RULES, head_dims=(2, 2))
    if _build.on_cpu("prefill_attention", q, k, v):
        return prefill_attention_plain(q, k, v, **kw)
    return _kernel(q, k, v, **kw)


def _kernel(q, k, v, *, causal: bool, window: int, prefix_len: int):
    """The CUDA launch on one device's tensors."""
    global launches
    B, S, H, hd = q.shape
    KV = k.shape[2]
    n = instance_hd(hd)
    _build.check_kernel_inputs("prefill_attention", torch.float32, q, k, v)
    q, k, v = (pad_hd(t, n) for t in (q, k, v))
    out = torch.empty_like(q)
    rc = _launch_fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                      B, S, H, KV, n, int(causal), int(window), int(prefix_len),
                      1.0 / math.sqrt(hd), _build.stream_ptr(q.device))
    _build.check(rc, "prefill_attention")
    launches += 1
    return out if n == hd else out[..., :hd].contiguous()
