"""B2: single-token GQA attention over a ring KV cache
(``csrc/decode_attention.cu``).

Counterpart of ``repro.kernels.decode_attention.decode_attention_pallas`` and of
the reference model's plain ``layers.decode_attention``: q (B, H, hd), k/v cache
(B, W, KV, hd), cache_len (B,) int32 -> (B, H, hd); ring entries at index
>= cache_len are ignored. Every caller on the serving path has cache_len >= 1.

:func:`decode_attention` runs the CUDA kernel on CUDA tensors and
:func:`decode_attention_plain` on CPU tensors. ``launches`` counts kernel
launches.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (64, 128)
MAX_GROUP = 8          # query heads per KV head the kernel takes
launches = 0


def decode_attention_plain(q, k_cache, v_cache, cache_len):
    """The reference's one-shot softmax over the valid ring entries."""
    B, H, hd = q.shape
    W, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    qg = q.float().reshape(B, KV, G, hd)
    s = torch.einsum("bkgh,btkh->bkgt", qg, k_cache.float()) / math.sqrt(hd)
    valid = (torch.arange(W, device=q.device)[None, :]
             < cache_len.reshape(-1, 1))                    # (B, W)
    s = torch.where(valid[:, None, None, :], s, torch.tensor(-1e30, device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgt,btkh->bkgh", p, v_cache.float())
    return out.reshape(B, H, hd).to(q.dtype)


def _launch_fn():
    fn = _build.library("decode_attention").decode_attention_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
        fn.restype = i
    return fn


def decode_attention(q, k_cache, v_cache, cache_len):
    """q (B, H, hd); k/v cache (B, W, KV, hd); cache_len (B,) int32
    -> (B, H, hd)."""
    global launches
    B, H, hd = q.shape
    if k_cache.shape != v_cache.shape or k_cache.ndim != 4 \
            or k_cache.shape[0] != B or k_cache.shape[3] != hd:
        raise ValueError(f"decode_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k_cache.shape)}, v {tuple(v_cache.shape)}")
    W, KV = k_cache.shape[1], k_cache.shape[2]
    if H % KV or cache_len.shape != (B,):
        raise ValueError(f"decode_attention: H={H} KV={KV} cache_len "
                         f"{tuple(cache_len.shape)}")
    if _build.on_cpu("decode_attention", q, k_cache, v_cache, cache_len):
        return decode_attention_plain(q, k_cache, v_cache, cache_len)
    if hd not in HEAD_DIMS or H // KV > MAX_GROUP:
        raise ValueError(f"decode_attention: the kernel takes hd in {HEAD_DIMS} "
                         f"and H/KV <= {MAX_GROUP}, got hd={hd}, H/KV={H // KV}")
    _build.check_kernel_inputs("decode_attention", torch.float32,
                               q, k_cache, v_cache)
    _build.check_kernel_inputs("decode_attention", torch.int32, cache_len)
    out = torch.empty_like(q)
    rc = _launch_fn()(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                      cache_len.data_ptr(), out.data_ptr(), B, H, W, KV, hd,
                      _build.stream_ptr(q.device))
    launches += 1
    _build.check(rc, "decode_attention")
    return out
