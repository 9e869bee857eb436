"""The retrieval-backend layer: one interface, execution strategies behind it.

The port's counterpart of ``repro.retrieval.backends``, with the strategies
this slice runs:

  * :class:`FlatBackend`           (``numpy``) — the numpy argpartition scan
                                     (single host, BLAS), copied from the
                                     reference.
  * :class:`TorchKernelBackend`    (``kernel``) — the EDR scan through the
                                     CUDA dense top-k kernel (B1) and the ADR
                                     probe through the fused gathered scan
                                     (B4), with the KB embeddings put on the
                                     device once, at construction.
  * :class:`QuantizedFlatBackend`  (``int8``) — the numpy scan over the int8
                                     KB, copied from the reference.
  * :class:`TorchQuantizedKernelBackend` (``int8-kernel``) — the int8 codes and
                                     scales on the device once; EDR through
                                     the int8 scan (B6), ADR through the int8
                                     fused gathered scan (B7).
  * :class:`ShardedBackend`        (``sharded``) — the KB cut into shards, each
                                     on its own device; one search runs B1
                                     (ADR: B4) on every shard and merges
                                     (``retrieval.sharded``).
  * :class:`QuantizedShardedBackend` (``int8-sharded``) — the same over the
                                     int8 codes and scales: B6 (ADR: B7) per
                                     shard.

The fp32 backends return identical ``(ids, scores)`` under the CANONICAL tie
order — score descending, then id ascending — so the serving layers can swap
them without perturbing a served token; the int8 pair is identical to each
other and holds recall@k >= 0.95 against the fp32 scan. Backends are pure
scans: the ``RetrieverStats`` bookkeeping lives in the retriever wrapper
(``retrievers._TimedRetriever``). The sharded pair equals its unsharded
kernel backend byte for byte (``retrieval.sharded``).
"""
from __future__ import annotations

from typing import Optional, Protocol, Tuple, runtime_checkable

import numpy as np
import torch

from repro_torch.kernels import gathered_topk as GT
from repro_torch.kernels.dense_topk import (MAX_K, dense_topk, pad_d, scan_scratch,
                                           sm_count)
from repro_torch.kernels.quant_topk import quant_dense_topk
from repro_torch.retrieval import sharded as SH

BACKENDS = ("numpy", "kernel", "sharded", "int8", "int8-kernel",
            "int8-sharded")


@runtime_checkable
class DenseSearchBackend(Protocol):
    """Pure dense top-k scan over a fixed KB embedding matrix."""

    name: str            # CLI spelling (one of BACKENDS)
    calls: int           # completed scans (sharded backends: collectives issued)
    exact: bool          # True: byte-parity with FlatBackend is contractual;
    #                      False: the bounded-recall contract applies instead
    #                      (recall@k >= 0.95 vs FlatBackend + determinism)
    kb_bytes: int        # resident index footprint (codes + scales if int8)

    def search(self, queries: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """queries (B, d) float32 -> (ids (B, k) int64, scores (B, k) float32),
        rows sorted canonically: score desc, ties by id asc."""
        ...

    def search_gathered(self, queries: np.ndarray, cand: np.ndarray,
                        k: int) -> Tuple[np.ndarray, np.ndarray]:
        """Masked/gathered scan: query b scores only the KB rows named by
        ``cand[b]`` (the IVF probe's padded bucket gather).

        ``cand`` is (B, C) int64: each row's candidate doc ids, sorted
        ascending, unique, padded with ``-1`` at the END (the retriever
        normalizes probe-order gathers into this form once — with ids in
        column order, every backend's position-stable top-k IS the canonical
        id-asc tie break). Returns ``(ids (B, k'), scores (B, k'))`` with
        ``k' = min(k, C)``, canonically ordered; slots beyond a row's real
        candidate count come back as ``(id=-1, score=-inf)``."""
        ...

    def cold_shape(self, B: int, k: int) -> bool:
        """True iff the NEXT search at this shape pays an XLA compile (and
        records the shape as seen). The compile cache lives on the backend,
        so retrievers sharing one backend agree on what is warm."""
        ...

    def cold_shape_gathered(self, B: int, C: int, k: int) -> bool:
        """`cold_shape` for the gathered scan — its compiled program is also
        shaped by the candidate width ``C``."""
        ...

    def gathered_scratch_bytes(self, B: int, C: int) -> int:
        """Peak candidate-buffer bytes ONE ``search_gathered`` call at batch B
        and candidate width C materializes — the gathered-embedding scratch,
        not the resident KB. The kernel backends gather inside the kernel on
        the card, so this is the wrapper's partial-list sort keys, a few
        bytes per (query, column split, k) and no rows at all (their plain
        versions on the CPU gather the (B, C, d) rows); the numpy paths
        report their row-chunked host scratch. Benchmarks
        record it next to :meth:`pregathered_scratch_bytes` (the (B, C, d)
        tensor the pre-gathered path would build) to track the reduction."""
        ...

    def pregathered_scratch_bytes(self, B: int, C: int) -> int:
        """What a naive pre-gathered (B, C, d) candidate materialization costs
        at this backend's resident dtype (int8 backends also gather a (B, C)
        fp32 scale row). The baseline `gathered_scratch_bytes` is measured
        against."""
        ...


class _JitShapeMixin:
    """Per-(B, k) compile tracking for jit-backed scans. ``n_rows`` is the
    KB size the backend clamps k against — distinct raw k values that clamp
    to the same compiled program must share one cache entry."""

    def _init_shapes(self, n_rows: int):
        self._shapes = set()
        self._n_rows = n_rows

    def cold_shape(self, B: int, k: int) -> bool:
        key = (B, min(k, self._n_rows))
        if key in self._shapes:
            return False
        self._shapes.add(key)
        return True

    def cold_shape_gathered(self, B: int, C: int, k: int) -> bool:
        key = (B, C, min(k, C))          # 3-tuples: never collide with dense
        if key in self._shapes:
            return False
        self._shapes.add(key)
        return True


def canonical_topk(s: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Top-k of a scored matrix ``s`` (B, N) under the canonical tie order
    (score desc, id asc) — the order ``jax.lax.top_k`` and the Pallas kernel's
    max-extraction loop both produce, so numpy results are comparable
    byte-for-byte with the accelerator backends.

    Vectorized fast path: argpartition for the top-k *set*, candidate ids
    sorted ascending, then a stable sort on score. argpartition picks
    arbitrary members among ties AT the k-th score, so rows where the
    boundary is ambiguous (more ties at the threshold than slots left) are
    re-selected exactly: all ids strictly above the threshold, then the
    lowest ids at it."""
    B, N = s.shape
    k = min(k, N)
    cand = np.argpartition(-s, kth=k - 1, axis=1)[:, :k] if k < N \
        else np.tile(np.arange(N), (B, 1))
    cand = np.sort(cand, axis=1)                      # ties resolve id-asc
    part = np.take_along_axis(s, cand, axis=1)
    thresh = part.min(axis=1)                         # k-th largest per row
    n_gt = (s > thresh[:, None]).sum(axis=1)
    ambiguous = np.nonzero((s == thresh[:, None]).sum(axis=1) > k - n_gt)[0]
    for b in ambiguous:                               # boundary ties: exact fix
        gt = np.nonzero(s[b] > thresh[b])[0]
        eq = np.nonzero(s[b] == thresh[b])[0][:k - gt.size]
        cand[b] = np.concatenate([gt, eq])
        part[b] = s[b, cand[b]]
    order = np.argsort(-part, axis=1, kind="stable")  # stable: keeps id-asc
    ids = np.take_along_axis(cand, order, axis=1).astype(np.int64)
    return ids, np.take_along_axis(part, order, axis=1).astype(np.float32)


def gathered_scores(embeddings: np.ndarray, queries: np.ndarray,
                    cand: np.ndarray) -> np.ndarray:
    """Score each query against ITS candidate rows: ``(B, C)`` float32 with
    pad slots (``cand < 0``) at ``-inf``. Row-chunked so the ``(rows, C, d)``
    gather stays ~64MB — big-KB probes would otherwise materialize GB-scale
    scratch per merged verification call. ``np.matmul`` over a stacked batch
    is per-row deterministic, so chunking cannot change a single bit."""
    B, C = cand.shape
    d = embeddings.shape[1]
    s = np.empty((B, C), np.float32)
    step = max(1, 16_000_000 // max(C * d, 1))
    for i in range(0, B, step):
        emb = embeddings[np.maximum(cand[i:i + step], 0)]
        s[i:i + step] = np.matmul(emb, queries[i:i + step, :, None])[..., 0]
    return np.where(cand >= 0, s, -np.inf)


def quantize_kb(embeddings: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-row symmetric int8 quantization of a KB embedding matrix:
    ``(N, d) float -> (codes (N, d) int8, scales (N,) float32)`` with
    ``scales = max(|row|) / 127`` (floored at 1e-12 so all-zero rows stay
    finite) and ``codes = clip(rint(row / scale), -127, 127)``. In numpy, as
    in the reference, so the codes equal the JAX package's byte for byte;
    every int8 backend calls THIS function, so both score one code matrix."""
    emb = np.asarray(embeddings, np.float32)
    maxabs = np.abs(emb).max(axis=1, initial=0.0)
    scales = (np.maximum(maxabs, np.float32(1e-12))
              / np.float32(127.0)).astype(np.float32)
    codes = np.clip(np.rint(emb / scales[:, None]), -127, 127).astype(np.int8)
    return codes, scales


def quant_scores(codes: np.ndarray, scales: np.ndarray,
                 queries: np.ndarray) -> np.ndarray:
    """Dequantized full scan ``(q @ codes.T) * scales`` -> (B, N) float32.
    The scale multiply lands on the score matrix (a per-row scale is constant
    along d, so ``q . (s*c) == s * (q . c)`` exactly in the reals) — the same
    operation order as the int8 kernel. KB-row chunked so the fp32 cast of
    the codes stays ~64MB scratch instead of a full fp32 KB copy per call."""
    B, (N, d) = queries.shape[0], codes.shape
    s = np.empty((B, N), np.float32)
    step = max(1, 16_000_000 // max(d, 1))
    for i in range(0, N, step):
        blk = codes[i:i + step].astype(np.float32)
        s[:, i:i + step] = (queries @ blk.T) * scales[None, i:i + step]
    return s


def quant_gathered_scores(codes: np.ndarray, scales: np.ndarray,
                          queries: np.ndarray, cand: np.ndarray) -> np.ndarray:
    """:func:`gathered_scores` over an int8 KB: each query scores ITS
    candidate rows as ``(q . code) * scale``; pad slots (``cand < 0``) at
    ``-inf``. Same ~64MB row chunking as the fp32 path."""
    B, C = cand.shape
    d = codes.shape[1]
    s = np.empty((B, C), np.float32)
    step = max(1, 16_000_000 // max(C * d, 1))
    for i in range(0, B, step):
        idx = np.maximum(cand[i:i + step], 0)
        emb = codes[idx].astype(np.float32)
        s[i:i + step] = (np.matmul(emb, queries[i:i + step, :, None])[..., 0]
                         * scales[idx])
    return np.where(cand >= 0, s, -np.inf)


def _stable_gathered_topk(s: np.ndarray, cand: np.ndarray,
                          k: int) -> Tuple[np.ndarray, np.ndarray]:
    """cand columns are id-sorted with pads (-inf) last, so a stable sort on
    score alone IS the canonical order — and pads can never displace real
    candidates."""
    order = np.argsort(-s, axis=1, kind="stable")[:, :min(k, cand.shape[1])]
    ids = np.take_along_axis(cand, order, axis=1).astype(np.int64)
    return ids, np.take_along_axis(s, order, axis=1).astype(np.float32)


def _sentinels_to_contract(ids, scores) -> Tuple[np.ndarray, np.ndarray]:
    """Device gathered-scan output -> the search_gathered contract: pad slots
    carry the NEG sentinel on device (kernels/dense_topk.NEG) with id -1;
    the contract (and the numpy path) says (id=-1, score=-inf)."""
    ids = np.asarray(ids, np.int64)
    return ids, np.where(ids < 0, np.float32(-np.inf),
                         np.asarray(scores, np.float32))


class FlatBackend:
    """Single-host numpy scan: one BLAS matmul + canonical argpartition top-k."""

    name = "numpy"
    exact = True

    def __init__(self, embeddings: np.ndarray):
        self.embeddings = embeddings
        self.kb_bytes = embeddings.nbytes
        self.calls = 0

    def cold_shape(self, B: int, k: int) -> bool:
        return False                     # nothing compiles

    def cold_shape_gathered(self, B: int, C: int, k: int) -> bool:
        return False

    def gathered_scratch_bytes(self, B: int, C: int) -> int:
        # gathered_scores row-chunks the (rows, C, d) f32 gather to ~64MB
        d = self.embeddings.shape[1]
        step = max(1, 16_000_000 // max(C * d, 1))
        return min(B, step) * C * d * 4

    def pregathered_scratch_bytes(self, B: int, C: int) -> int:
        return B * C * self.embeddings.shape[1] * 4

    def search(self, queries: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
        s = queries @ self.embeddings.T                  # (B, N)
        self.calls += 1
        return canonical_topk(s, k)

    def search_gathered(self, queries: np.ndarray, cand: np.ndarray,
                        k: int) -> Tuple[np.ndarray, np.ndarray]:
        s = gathered_scores(self.embeddings, queries, cand)
        self.calls += 1
        return _stable_gathered_topk(s, cand, k)


def _to_device(array: np.ndarray, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(array, dtype)).to(device)


def _kernel_scratch_bytes(device, B: int, C: int, k: int, row_bytes: int) -> int:
    """Bytes one gathered kernel-wrapper call allocates beyond its inputs and
    outputs: on CUDA the scan's sort keys (8 bytes each); on the CPU the
    plain version's gathered rows, cast to fp32 ((B, C, d) x 4 bytes)."""
    if device.type == "cuda":
        return scan_scratch(B, C, min(k, C), sm_count(device), per_query=True)[1]
    return B * C * row_bytes


class TorchKernelBackend(_JitShapeMixin):
    """EDR scan through the CUDA dense top-k kernel (B1), ADR probe through
    the fused gathered scan (B4). The KB embedding matrix is put on
    ``device`` ONCE here — per-call uploads of a multi-GB index would dwarf
    the scan itself; each call moves only the (B, d) queries (and the (B, C)
    candidate ids) to the device and the (B, k) results back. On a CPU device
    the kernel wrappers run their plain PyTorch versions (same results on the
    grid-quantized KBs the tests use). The KB is zero-padded to a multiple
    of 4 columns at upload and each call's queries alike, which the kernels'
    16-byte copies need; a zero pair adds exactly 0 to every score, so any d
    is served without a per-call copy of the KB. ``cold_shape`` flags the
    first call per shape like the reference's jit cache: on the card that
    call also pays the kernel library's load."""

    name = "kernel"
    exact = True

    def __init__(self, embeddings: np.ndarray, device=None):
        from repro_torch import resolve_device
        self.device = resolve_device(device)
        self._kb = pad_d(_to_device(embeddings, np.float32, self.device), 4)
        self._d = embeddings.shape[1]
        self.kb_bytes = self._kb.numel() * self._kb.element_size()
        self.calls = 0
        self._init_shapes(self._kb.shape[0])

    def gathered_scratch_bytes(self, B: int, C: int, k: int = MAX_K) -> int:
        """What one ``search_gathered`` call's kernel wrapper allocates at
        this k (default: the largest k of the kernels' fast path, the most
        a serving call asks for)."""
        return _kernel_scratch_bytes(self.device, B, C, k, self._kb.shape[1] * 4)

    def pregathered_scratch_bytes(self, B: int, C: int) -> int:
        return B * C * self._d * 4

    def search(self, queries: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
        q = pad_d(_to_device(queries, np.float32, self.device), 4)
        # same k > N clamp as the other backends: identical (B, min(k, N))
        # results everywhere
        scores, ids = dense_topk(q, self._kb, min(k, self._kb.shape[0]))
        self.calls += 1
        return ids.cpu().numpy().astype(np.int64), scores.cpu().numpy()

    def search_gathered(self, queries: np.ndarray, cand: np.ndarray,
                        k: int) -> Tuple[np.ndarray, np.ndarray]:
        q = pad_d(_to_device(queries, np.float32, self.device), 4)
        c = _to_device(cand, np.int32, self.device)
        scores, ids = GT.fused_gathered_topk(q, self._kb, c, min(k, cand.shape[1]))
        self.calls += 1
        return _sentinels_to_contract(ids.cpu().numpy(), scores.cpu().numpy())


class QuantizedFlatBackend:
    """Single-host numpy scan over the int8 KB: the quantized family's
    reference semantics. Scores are ``(q @ codes.T) * scales`` with the scale
    multiply on the score matrix (the kernel's operation order), then the
    same canonical top-k as :class:`FlatBackend`. Inexact by contract — what
    it promises is recall@k >= 0.95 vs the fp32 scan, not byte-parity."""

    name = "int8"
    exact = False

    def __init__(self, embeddings: np.ndarray):
        self.codes, self.scales = quantize_kb(embeddings)
        self.kb_bytes = self.codes.nbytes + self.scales.nbytes
        self.calls = 0

    def cold_shape(self, B: int, k: int) -> bool:
        return False                     # nothing compiles

    def cold_shape_gathered(self, B: int, C: int, k: int) -> bool:
        return False

    def gathered_scratch_bytes(self, B: int, C: int) -> int:
        # quant_gathered_scores casts each row-chunk's codes to f32
        d = self.codes.shape[1]
        step = max(1, 16_000_000 // max(C * d, 1))
        return min(B, step) * C * d * 4

    def pregathered_scratch_bytes(self, B: int, C: int) -> int:
        return B * C * (self.codes.shape[1] + 4)    # int8 codes + f32 scales

    def search(self, queries: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
        s = quant_scores(self.codes, self.scales,
                         np.asarray(queries, np.float32))
        self.calls += 1
        return canonical_topk(s, k)

    def search_gathered(self, queries: np.ndarray, cand: np.ndarray,
                        k: int) -> Tuple[np.ndarray, np.ndarray]:
        s = quant_gathered_scores(self.codes, self.scales,
                                  np.asarray(queries, np.float32), cand)
        self.calls += 1
        return _stable_gathered_topk(s, cand, k)


class TorchQuantizedKernelBackend(_JitShapeMixin):
    """The int8 scans on the device: codes and fp32 row scales from
    :func:`quantize_kb` are put on ``device`` ONCE here. EDR runs the int8
    scan (B6), which reads a quarter of the fp32 KB's bytes; the ADR probe
    runs the int8 fused gathered scan (B7), which gathers each candidate's
    codes and scale by id. The codes are zero-padded to a multiple of 16
    columns at upload (the queries per call), as the fp32 KB is to 4 in
    :class:`TorchKernelBackend`. Inexact by contract, like
    :class:`QuantizedFlatBackend`, whose results it equals."""

    name = "int8-kernel"
    exact = False

    def __init__(self, embeddings: np.ndarray, device=None):
        from repro_torch import resolve_device
        self.device = resolve_device(device)
        codes, scales = quantize_kb(embeddings)
        self._codes = pad_d(_to_device(codes, np.int8, self.device), 16)
        self._scales = _to_device(scales, np.float32, self.device)
        self._d = codes.shape[1]
        self.kb_bytes = self._codes.numel() + scales.nbytes     # resident, padded
        self.calls = 0
        self._init_shapes(codes.shape[0])

    def gathered_scratch_bytes(self, B: int, C: int, k: int = MAX_K) -> int:
        """What one ``search_gathered`` call's kernel wrapper allocates at
        this k (default: the largest k of the kernels' fast path, the most
        a serving call asks for)."""
        return _kernel_scratch_bytes(self.device, B, C, k, self._codes.shape[1] * 4)

    def pregathered_scratch_bytes(self, B: int, C: int) -> int:
        return B * C * (self._d + 4)

    def search(self, queries: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
        q = pad_d(_to_device(queries, np.float32, self.device), 16)
        scores, ids = quant_dense_topk(q, self._codes, self._scales,
                                       min(k, self._codes.shape[0]))
        self.calls += 1
        return ids.cpu().numpy().astype(np.int64), scores.cpu().numpy()

    def search_gathered(self, queries: np.ndarray, cand: np.ndarray,
                        k: int) -> Tuple[np.ndarray, np.ndarray]:
        q = pad_d(_to_device(queries, np.float32, self.device), 16)
        c = _to_device(cand, np.int32, self.device)
        scores, ids = GT.quant_fused_gathered_topk(q, self._codes, self._scales, c,
                                                   min(k, cand.shape[1]))
        self.calls += 1
        return _sentinels_to_contract(ids.cpu().numpy(), scores.cpu().numpy())


class ShardedBackend(_JitShapeMixin):
    """The KB cut into ``n_shards`` contiguous shards of ``ceil(N / S)``
    rows, each put ONCE on its own device (``retrieval.sharded.
    shard_devices``: round-robin over the visible cards from ``device``'s
    type; default one shard a card, one on the CPU). A search scans every
    shard with its kernel (EDR: B1; ADR: B4 over the shard's own candidates)
    and merges the shards' candidates on ``device``: one merged call, which
    ``calls`` counts, so the fleet's one-call-per-round invariant is
    asserted against it. Rows are zero-padded in d at upload, as in
    :class:`TorchKernelBackend`, whose results this backend equals byte for
    byte. The resident representation is a hook (:meth:`_encode`):
    :class:`QuantizedShardedBackend` places int8 codes and row scales
    instead."""

    name = "sharded"
    exact = True
    _vec = 4                               # elements of one 16-byte copy of a row

    def __init__(self, embeddings: np.ndarray, n_shards: Optional[int] = None,
                 device=None):
        from repro_torch import resolve_device
        self.device = resolve_device(device)
        self.devices = SH.shard_devices(n_shards, self.device)
        self.n_shards = len(self.devices)
        self.n_total, self._d = embeddings.shape
        matrix, scales = self._encode(embeddings)
        bounds = SH.shard_bounds(self.n_total, self.n_shards)
        self._rows = [pad_d(_to_device(matrix[lo:hi], matrix.dtype, dev), self._vec)
                      for (lo, hi), dev in zip(bounds, self.devices)]
        self._scales = None if scales is None else [
            _to_device(scales[lo:hi], np.float32, dev)
            for (lo, hi), dev in zip(bounds, self.devices)]
        self.kb_bytes = sum(r.numel() * r.element_size() for r in self._rows) + (
            0 if scales is None else scales.nbytes)
        self.calls = 0
        self._init_shapes(self.n_total)

    def _encode(self, embeddings: np.ndarray):
        """Resident representation: ``(matrix (N, d), per-row scales | None)``."""
        return np.asarray(embeddings, np.float32), None

    def gathered_scratch_bytes(self, B: int, C: int, k: int = MAX_K) -> int:
        """What one shard's kernel wrapper allocates at most in one
        ``search_gathered`` (the shards run one after another), beside the
        (B, C) shard-local candidate ids it scans."""
        row_bytes = self._rows[0].shape[1] * 4
        return B * C * 4 + _kernel_scratch_bytes(self.devices[0], B, C, k, row_bytes)

    def pregathered_scratch_bytes(self, B: int, C: int) -> int:
        return B * C * (self._d * 4 if self._scales is None else self._d + 4)

    def search(self, queries: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
        q = pad_d(_to_device(queries, np.float32, self.device), self._vec)
        scores, ids = SH.sharded_dense_topk(q, self._rows, min(k, self.n_total),
                                            n_total=self.n_total, scales=self._scales)
        self.calls += 1
        return ids.cpu().numpy(), scores.cpu().numpy()

    def search_gathered(self, queries: np.ndarray, cand: np.ndarray,
                        k: int) -> Tuple[np.ndarray, np.ndarray]:
        q = pad_d(_to_device(queries, np.float32, self.device), self._vec)
        c = _to_device(cand, np.int64, self.device)
        scores, ids = SH.sharded_gathered_topk(q, self._rows, c, k, n_total=self.n_total,
                                               scales=self._scales)
        self.calls += 1
        return _sentinels_to_contract(ids.cpu().numpy(), scores.cpu().numpy())


class QuantizedShardedBackend(ShardedBackend):
    """Per-shard int8 residency: each shard holds its slice of the
    :func:`quantize_kb` codes (zero-padded to 16 columns) and row scales,
    scanned by B6 (ADR: B7); otherwise the fp32 sharded backend, one merged
    call per search. Equals :class:`TorchQuantizedKernelBackend` byte for
    byte; inexact by contract, like it."""

    name = "int8-sharded"
    exact = False
    _vec = 16

    def _encode(self, embeddings: np.ndarray):
        return quantize_kb(embeddings)


def make_backend(name: str, embeddings: np.ndarray, *, n_shards: Optional[int] = None,
                 device=None):
    """Backend factory keyed by CLI name (one of :data:`BACKENDS`);
    ``device`` is where the kernel backends keep the KB (default: CUDA), and
    ``n_shards`` the sharded backends' shard count (default: one a visible
    card)."""
    if name == "numpy":
        return FlatBackend(embeddings)
    if name == "kernel":
        return TorchKernelBackend(embeddings, device=device)
    if name == "sharded":
        return ShardedBackend(embeddings, n_shards=n_shards, device=device)
    if name == "int8":
        return QuantizedFlatBackend(embeddings)
    if name == "int8-kernel":
        return TorchQuantizedKernelBackend(embeddings, device=device)
    if name == "int8-sharded":
        return QuantizedShardedBackend(embeddings, n_shards=n_shards, device=device)
    raise KeyError(f"unknown retrieval backend {name!r}; known: {BACKENDS}")
