"""B2: single-token GQA attention over a ring KV cache
(``csrc/decode_attention.cu``).

Counterpart of ``repro.kernels.decode_attention.decode_attention_pallas`` and of
the reference model's plain ``layers.decode_attention``: q (B, H, hd), k/v cache
(B, W, KV, hd), cache_len (B,) int32 -> (B, H, hd), for any H % KV == 0; ring
entries at index >= cache_len are ignored, and cache_len > W counts as W. A
slot with cache_len <= 0 has every entry masked, so its softmax weights are
equal and its output is the mean of v over the whole window, as the
reference's is. Every caller on the serving path has cache_len >= 1.

:func:`decode_attention` runs the CUDA kernel on CUDA tensors, at any hd
(the kernel is built for the widths in :data:`HEAD_DIMS`, and any other hd
up to :data:`MAX_HD` is zero-padded to the next of them, with the real hd's
softmax scale; above it a separate wide-head kernel takes hd zero-padded to
a multiple of 4), and :func:`decode_attention_plain` on CPU tensors.
``launches`` counts kernel launches. DTensor inputs go through
``mesh_ops.on_mesh``: the plain version op by op on a mesh of meta or CPU
shards, the kernel on each rank's CUDA shards where :data:`MESH_RULES`
allow. The kernel has no backward: the wrapper
raises on inputs that require grad under grad mode, on either device. The kernel splits each slot's cache into chunks of
:data:`CHUNK` entries (above :data:`MAX_HD`, of :data:`WIDE_CHUNK` or a
multiple of it, :data:`WIDE_MAX_CHUNKS` at most a slot; :func:`partials_size`).
The wrapper keeps, per device, the scratch for the
chunks' partials and a zeroed ticket buffer, which each launch leaves
zeroed; both are made (or grown) on a call, so before any CUDA-graph
capture that the caller warms up for, and a call allocates nothing else but
its output. Calls that share a device share that scratch, so they must not
run concurrently on two streams; the port issues them all on one.
"""
from __future__ import annotations

import ctypes
import math

import torch
from torch.distributed.tensor import Replicate, Shard

from repro_torch.distributed import mesh_ops
from repro_torch.kernels import _build

HEAD_DIMS = (16, 32, 64, 112, 128, 256)   # the kernel's instances (csrc/decode_attention.cu)
MAX_HD = HEAD_DIMS[-1]  # above it: the wide-head kernel (csrc/wide_attention.cuh)
CHUNK = 64             # cache entries per CTA (kChunk in csrc/decode_attention.cu)
WIDE_CHUNK = 32        # above MAX_HD: the shortest chunk (kWideBlock)
WIDE_MAX_CHUNKS = 64   # above MAX_HD: a slot's chunks at most (kWideMaxChunks)
MIN_SCRATCH = 1 << 18  # ticket ints and partial floats that a device's first scratch holds
launches = 0
# on one mesh dim, the placements of (q, k_cache, v_cache, cache_len) under
# which each rank attends its shards alone, and the output's: all whole, the
# batch split, or the heads split (query heads with their KV heads)
MESH_RULES = (((Replicate(),) * 4, Replicate()),
              ((Shard(0),) * 4, Shard(0)),
              ((Shard(1), Shard(2), Shard(2), Replicate()), Shard(1)))
_scratch: dict = {}    # device index -> (tickets, partials, their pointers, their sizes)
_outgrown: list = []   # scratch a larger call replaced: a captured launch may still use it


def decode_attention_plain(q, k_cache, v_cache, cache_len):
    """The reference's one-shot softmax over the valid ring entries. On a
    mesh where the query heads are split finer than the KV heads, the one
    query row's heads are gathered first (``mesh_ops.whole_heads``)."""
    B, H, hd = q.shape
    W, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    q = mesh_ops.whole_heads(q, KV, 1)
    qg = q.float().reshape(B, KV, G, hd)
    s = torch.einsum("bkgh,btkh->bkgt", qg, k_cache.float()) / math.sqrt(hd)
    valid = (torch.arange(W, device=q.device)[None, :]
             < cache_len.reshape(-1, 1))                    # (B, W)
    s = torch.where(valid[:, None, None, :], s, torch.tensor(-1e30, device=q.device))
    p = mesh_ops.softmax_last(s)
    out = torch.einsum("bkgt,btkh->bkgh", p, v_cache.float())
    return out.reshape(B, H, hd).to(q.dtype)


def _launch_fn():
    fn = _build.library("decode_attention").decode_attention_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, ctypes.c_float, p]
        fn.restype = i
    return fn


def instance_hd(hd: int) -> int:
    """The head dim a kernel launch runs at: the smallest of
    :data:`HEAD_DIMS` that holds ``hd``, or above :data:`MAX_HD` ``hd``
    rounded up to a multiple of 4 (the wide-head kernel's 16-byte rows)."""
    for n in HEAD_DIMS:
        if hd <= n:
            return n
    return -(-hd // 4) * 4


def pad_hd(t: torch.Tensor, n: int) -> torch.Tensor:
    """t (..., hd) zero-padded on its last dim to n: a zero lane adds 0 to
    every score and gives a zero output column."""
    hd = t.shape[-1]
    return t if hd == n else torch.nn.functional.pad(t, (0, n - hd)).contiguous()


def partials_size(B: int, H: int, W: int, n: int) -> int:
    """Floats of the chunks' partials that a launch at instance head dim n
    writes: an (acc, m, l) row of n + 2 floats per query head, slot and
    chunk of the grid (ceil(W / CHUNK) chunks; above MAX_HD ceil(W /
    WIDE_CHUNK), at most WIDE_MAX_CHUNKS)."""
    if n > MAX_HD:
        chunks = min(-(-W // WIDE_CHUNK), WIDE_MAX_CHUNKS)
    else:
        chunks = -(-W // CHUNK)
    return B * H * chunks * (n + 2)


def _scratch_for(device, n_tickets: int, n_partials: int):
    """The device's ticket counters (zeroed when made) and partials scratch,
    remade larger when a call needs more -> (tickets, partials, their data
    pointers, their sizes). The scratch a remake replaces is kept: a launch
    captured in a CUDA graph (``models.model.DecodeGraph``) holds its
    pointers for as long as the graph replays."""
    s = _scratch.get(device.index)
    if s is None or s[4] < n_tickets or s[5] < n_partials:
        if s is not None:
            _outgrown.append(s)
        n_tickets, n_partials = max(n_tickets, MIN_SCRATCH), max(n_partials, MIN_SCRATCH)
        tickets = torch.zeros(n_tickets, dtype=torch.int32, device=device)
        part = torch.empty(n_partials, dtype=torch.float32, device=device)
        s = _scratch[device.index] = (tickets, part, tickets.data_ptr(), part.data_ptr(),
                                      n_tickets, n_partials)
    return s


def decode_attention(q, k_cache, v_cache, cache_len):
    """q (B, H, hd); k/v cache (B, W, KV, hd); cache_len (B,) int32
    -> (B, H, hd)."""
    B, H, hd = q.shape
    if k_cache.shape != v_cache.shape or k_cache.ndim != 4 \
            or k_cache.shape[0] != B or k_cache.shape[3] != hd:
        raise ValueError(f"decode_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k_cache.shape)}, v {tuple(v_cache.shape)}")
    KV = k_cache.shape[2]
    if H % KV or cache_len.shape != (B,):
        raise ValueError(f"decode_attention: H={H} KV={KV} cache_len "
                         f"{tuple(cache_len.shape)}")
    _build.refuse_grad("decode_attention", q, k_cache, v_cache)
    args = (q, k_cache, v_cache, cache_len)
    if mesh_ops.is_distributed(*args):
        return mesh_ops.on_mesh("decode_attention", _kernel, decode_attention_plain, args,
                                MESH_RULES, head_dims=(1, 2))
    if _build.on_cpu("decode_attention", *args):
        return decode_attention_plain(*args)
    return _kernel(*args)


def _kernel(q, k_cache, v_cache, cache_len):
    """The CUDA launch on one device's tensors."""
    global launches
    B, H, hd = q.shape
    W, KV = k_cache.shape[1], k_cache.shape[2]
    n = instance_hd(hd)
    _build.check_kernel_inputs("decode_attention", torch.float32,
                               q, k_cache, v_cache)
    _build.check_kernel_inputs("decode_attention", torch.int32, cache_len)
    q, k_cache, v_cache = (pad_hd(t, n) for t in (q, k_cache, v_cache))
    out = torch.empty_like(q)
    scratch = _scratch_for(q.device, B * KV, partials_size(B, H, W, n))
    rc = _launch_fn()(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                      cache_len.data_ptr(), out.data_ptr(), scratch[3], scratch[2],
                      B, H, W, KV, n, 1.0 / math.sqrt(hd), _build.stream_ptr(q.device))
    launches += 1
    _build.check(rc, "decode_attention")
    return out if n == hd else out[..., :hd].contiguous()
