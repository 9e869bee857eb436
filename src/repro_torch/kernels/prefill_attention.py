"""B3: blockwise (flash) attention for prefill (``csrc/prefill_attention.cu``).

Counterpart of ``repro.kernels.prefill_attention.prefill_attention_pallas``,
and on the card of the reference model's ``plain_attention`` /
``blockwise_attention``: q (B, S, H, hd), k/v (B, S, KV, hd) -> (B, S, H, hd);
causal (optionally with a bidirectional prefix of ``prefix_len`` positions),
optional sliding ``window``, GQA.

:func:`prefill_attention` runs the CUDA kernel on CUDA tensors and
:func:`prefill_attention_plain` on CPU tensors. ``launches`` counts kernel
launches.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (64, 128)
launches = 0


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
    """The reference's plain_attention: the full (S, T) score matrix."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.float().reshape(B, S, KV, G, hd)
    s = torch.einsum("bqkgh,btkh->bqkgt", qg, k.float()) / math.sqrt(hd)
    msk = allowed_mask(S, T, causal=causal, window=window,
                       prefix_len=prefix_len, device=q.device)
    s = torch.where(msk[None, :, None, None, :], s,
                    torch.tensor(-1e30, device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bqkgt,btkh->bqkgh", p, v.float())
    return out.reshape(B, S, H, hd).to(q.dtype)


def _launch_fn():
    fn = _build.library("prefill_attention").prefill_attention_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, p]
        fn.restype = i
    return fn


def prefill_attention(q, k, v, *, causal: bool = True, window: int = 0,
                      prefix_len: int = 0):
    """q (B, S, H, hd); k/v (B, S, KV, hd) -> (B, S, H, hd)."""
    global launches
    B, S, H, hd = q.shape
    if k.shape != v.shape or k.ndim != 4 or k.shape[:2] != (B, S) \
            or k.shape[3] != hd or H % k.shape[2]:
        raise ValueError(f"prefill_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    KV = k.shape[2]
    if _build.on_cpu("prefill_attention", q, k, v):
        return prefill_attention_plain(q, k, v, causal=causal, window=window,
                                       prefix_len=prefix_len)
    if hd not in HEAD_DIMS:
        raise ValueError(f"prefill_attention: the kernel takes hd in "
                         f"{HEAD_DIMS}, got {hd}")
    _build.check_kernel_inputs("prefill_attention", torch.float32, q, k, v)
    out = torch.empty_like(q)
    rc = _launch_fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                      B, S, H, KV, hd, int(causal), int(window),
                      int(prefix_len), _build.stream_ptr(q.device))
    launches += 1
    _build.check(rc, "prefill_attention")
    return out
