"""The retrieval-backend layer: one interface, execution strategies behind it.

The port's counterpart of ``repro.retrieval.backends``, with the strategies
this slice runs:

  * :class:`FlatBackend`        (``numpy``) — the numpy argpartition scan
                                  (single host, BLAS), copied from the
                                  reference.
  * :class:`TorchKernelBackend` (``kernel``) — the EDR scan through the CUDA
                                  dense top-k kernel (B1,
                                  ``repro_torch.kernels.dense_topk``), with the
                                  KB embeddings put on the device once, at
                                  construction.

Both return identical ``(ids, scores)`` under the CANONICAL tie order — score
descending, then id ascending — so the serving layers can swap them without
perturbing a served token. Backends are pure scans: the ``RetrieverStats``
bookkeeping lives in the retriever wrapper (``retrievers._TimedRetriever``).
The sharded and int8 backends, and the gathered (ADR) scan on the device, are
later slices (ROADMAP.md).
"""
from __future__ import annotations

from typing import Protocol, Tuple, runtime_checkable

import numpy as np
import torch

from repro_torch.kernels.dense_topk import dense_topk

BACKENDS = ("numpy", "kernel")


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
        not the resident KB. Kernel/sharded backends route through the fused
        in-kernel gather, so this is a (B, block_c, d) tile independent of C;
        the numpy paths report their row-chunked host scratch. Benchmarks
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
        k2 = min(k, cand.shape[1])
        # cand columns are id-sorted with pads (-inf) last, so a stable sort
        # on score alone IS the canonical order — and pads can never displace
        # real candidates
        order = np.argsort(-s, axis=1, kind="stable")[:, :k2]
        ids = np.take_along_axis(cand, order, axis=1).astype(np.int64)
        self.calls += 1
        return ids, np.take_along_axis(s, order, axis=1).astype(np.float32)


class TorchKernelBackend(_JitShapeMixin):
    """EDR scan through the CUDA dense top-k kernel (B1). The KB embedding
    matrix is put on ``device`` ONCE here — per-call uploads of a multi-GB
    index would dwarf the scan itself; each call moves only the (B, d)
    queries to the device and the (B, k) results back. On a CPU device the
    kernel wrapper runs its plain PyTorch version (same results on the
    grid-quantized KBs the tests use). ``cold_shape`` flags the first call
    per (B, k) like the reference's jit cache: on the card that call also
    pays the kernel library's load."""

    name = "kernel"
    exact = True

    def __init__(self, embeddings: np.ndarray, device=None):
        from repro_torch import resolve_device
        self.device = resolve_device(device)
        self._kb = torch.as_tensor(np.asarray(embeddings, np.float32)).to(
            self.device).contiguous()
        self.kb_bytes = self._kb.numel() * self._kb.element_size()
        self.calls = 0
        self._init_shapes(self._kb.shape[0])

    def search(self, queries: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
        q = torch.as_tensor(np.ascontiguousarray(queries, np.float32)).to(
            self.device)
        # same k > N clamp as the other backends: identical (B, min(k, N))
        # results everywhere
        scores, ids = dense_topk(q, self._kb, min(k, self._kb.shape[0]))
        self.calls += 1
        return ids.cpu().numpy().astype(np.int64), scores.cpu().numpy()

    def search_gathered(self, queries: np.ndarray, cand: np.ndarray,
                        k: int) -> Tuple[np.ndarray, np.ndarray]:
        raise NotImplementedError(
            "TorchKernelBackend.search_gathered (the ADR probe, kernels B4/B5) "
            "comes with the ADR slice; use backend='numpy' for IVF retrieval")


def make_backend(name: str, embeddings: np.ndarray, device=None):
    """Backend factory keyed by CLI name (one of :data:`BACKENDS`)."""
    if name == "numpy":
        return FlatBackend(embeddings)
    if name == "kernel":
        return TorchKernelBackend(embeddings, device=device)
    raise KeyError(f"unknown retrieval backend {name!r}; known: {BACKENDS}")
