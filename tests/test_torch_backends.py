"""The port's backends held against the reference's.

``TorchKernelBackend`` (on the CPU: its kernels' plain versions), the port's
``FlatBackend`` and the reference's ``FlatBackend`` must agree byte for byte —
ids AND scores — on the grid-quantized, tie-heavy KBs of
tests/test_backends.py (every dot product exact in fp32, so only the
canonical tie order tells results apart), across batch sizes and k, KB sizes
that divide no block, and k > N; the gathered (ADR) scan too, with ragged
candidate rows, duplicate ids and all-pad rows. The int8 pair (``int8``,
``int8-kernel``) must equal the reference's ``QuantizedFlatBackend`` byte for
byte on grid KBs, and meet its recall@k >= 0.95 contract against the fp32
scan on the KB grid of tests/test_quantized.py.
"""
import numpy as np
import pytest
import torch

from repro.retrieval.backends import FlatBackend as RefFlat
from repro.retrieval.backends import QuantizedFlatBackend as RefQuantFlat
from repro.retrieval.backends import quantize_kb as ref_quantize_kb
from repro_torch.retrieval.backends import (BACKENDS, FlatBackend,
                                            QuantizedFlatBackend,
                                            TorchKernelBackend,
                                            TorchQuantizedKernelBackend,
                                            canonical_topk, make_backend,
                                            quantize_kb)
from repro_torch.retrieval.kb import DenseKB
from repro_torch.retrieval.retrievers import ExactDenseRetriever

# six xdist workers share the host's cores: one torch thread each
torch.set_num_threads(1)


def _grid(rng, n, d):
    return rng.integers(-2, 3, size=(n, d)).astype(np.float32) / 2


def _tie_heavy(rng, n, d):
    base = _grid(rng, max(n // 8, 2), d)
    return np.tile(base, (-(-n // base.shape[0]), 1))[:n]


@pytest.mark.parametrize("n,d", [(96, 16), (130, 8), (257, 32)])
@pytest.mark.parametrize("ties", [False, True])
def test_backend_parity_byte_identical(n, d, ties):
    rng = np.random.default_rng(n + d + ties)
    emb = _tie_heavy(rng, n, d) if ties else _grid(rng, n, d)
    ref, flat = RefFlat(emb), FlatBackend(emb)
    kern = TorchKernelBackend(emb, device="cpu")
    for B in (1, 3, 12):
        qs = _grid(rng, B, d)
        for k in (1, 5, 40):
            ri, rs = ref.search(qs, k)
            for name, (i, s) in (("numpy", flat.search(qs, k)),
                                 ("kernel", kern.search(qs, k))):
                assert i.dtype == np.int64 and s.dtype == np.float32
                assert i.shape == (B, min(k, n))
                assert np.array_equal(ri, i), f"{name} B={B} k={k}: ids"
                assert np.array_equal(rs, s), f"{name} B={B} k={k}: scores"
    assert kern.calls == flat.calls == 9


def test_backend_k_exceeds_kb_size():
    rng = np.random.default_rng(5)
    emb = _grid(rng, 12, 8)
    q = _grid(rng, 2, 8)
    ri, rs = RefFlat(emb).search(q, 50)
    kern = TorchKernelBackend(emb, device="cpu")
    ki, ks = kern.search(q, 50)
    assert ri.shape == ki.shape == (2, 12)
    assert np.array_equal(ri, ki) and np.array_equal(rs, ks)
    # first call per CLAMPED (B, k) is the cold one, as in the reference
    assert kern.cold_shape(2, 50) is True
    assert kern.cold_shape(2, 12) is False


def test_canonical_topk_tie_order():
    s = np.asarray([[1.0, 3.0, 3.0, 0.0, 3.0]], np.float32)
    ids, sc = canonical_topk(s, 2)
    assert ids.tolist() == [[1, 2]] and sc.tolist() == [[3.0, 3.0]]


def _ragged_cand(rng, B, C, N, dup_row=None, empty_row=None):
    cand = np.full((B, C), -1, np.int64)
    for b in range(B):
        if b == empty_row:
            continue
        w = int(rng.integers(1, min(C, N)))
        row = np.sort(rng.choice(N, size=w, replace=False))
        if b == dup_row and w >= 2:
            row[1] = row[0]
        cand[b, :w] = row
    return cand


@pytest.mark.parametrize("n,d,C", [(300, 16, 130), (700, 32, 520)])
def test_gathered_parity_byte_identical(n, d, C):
    """The ADR probe: kernel (plain on the CPU) == numpy == the reference,
    pads as (-1, -inf), k clamped to C."""
    rng = np.random.default_rng(n + C)
    emb = _tie_heavy(rng, n, d)
    ref, flat = RefFlat(emb), FlatBackend(emb)
    kern = TorchKernelBackend(emb, device="cpu")
    for B in (1, 5, 12):
        qs = _grid(rng, B, d)
        cand = _ragged_cand(rng, B, C, n, dup_row=0, empty_row=B - 1 if B > 1 else None)
        for k in (1, 8, 40, C + 7):
            ri, rs = ref.search_gathered(qs, cand, k)
            for name, (i, s) in (("numpy", flat.search_gathered(qs, cand, k)),
                                 ("kernel", kern.search_gathered(qs, cand, k))):
                assert i.dtype == np.int64 and s.dtype == np.float32
                assert i.shape == (B, min(k, C))
                assert np.array_equal(ri, i), f"{name} B={B} k={k}: ids"
                assert np.array_equal(rs, s), f"{name} B={B} k={k}: scores"
    assert kern.calls == flat.calls == 12


def test_int8_backends_match_reference_byte_identical():
    """quantize_kb equals the reference's byte for byte, and int8 and
    int8-kernel equal the reference QuantizedFlatBackend on search and on
    search_gathered."""
    rng = np.random.default_rng(21)
    for n, d in ((257, 16), (600, 32)):
        emb = _tie_heavy(rng, n, d)
        codes, scales = quantize_kb(emb)
        rc, rsc = ref_quantize_kb(emb)
        assert codes.tobytes() == rc.tobytes() and scales.tobytes() == rsc.tobytes()
        ref = RefQuantFlat(emb)
        ours = (QuantizedFlatBackend(emb), TorchQuantizedKernelBackend(emb, device="cpu"))
        for B in (1, 7):
            qs = _grid(rng, B, d)
            cand = _ragged_cand(rng, B, 150, n, dup_row=0)
            for k in (1, 10, 300):
                want = (ref.search(qs, k), ref.search_gathered(qs, cand, k))
                for b in ours:
                    got = (b.search(qs, k), b.search_gathered(qs, cand, k))
                    for (wi, ws), (gi, gs) in zip(want, got):
                        assert np.array_equal(wi, gi) and np.array_equal(ws, gs), \
                            f"{b.name} n={n} B={B} k={k}"


def _unit(rng, n, d):
    emb = rng.standard_normal((n, d)).astype(np.float32)
    return emb / np.linalg.norm(emb, axis=1, keepdims=True)


def _clustered(rng, n, d, n_centers=8, spread=0.15):
    centers = rng.standard_normal((n_centers, d)).astype(np.float32)
    emb = (centers[rng.integers(0, n_centers, n)]
           + spread * rng.standard_normal((n, d)).astype(np.float32))
    return emb / np.linalg.norm(emb, axis=1, keepdims=True)


def _tie_heavy_unit(rng, n, d):
    base = _unit(rng, max(n // 8, 2), d)
    return np.tile(base, (-(-n // base.shape[0]), 1))[:n].copy()


def _recall(ids, ref_ids):
    hits = []
    for row, ref in zip(ids, ref_ids):
        want = set(int(i) for i in ref if i >= 0)
        if want:
            hits.append(len(set(int(i) for i in row if i >= 0) & want) / len(want))
    return float(np.mean(hits))


@pytest.mark.parametrize("kind,make_kb", [("random", _unit), ("clustered", _clustered),
                                          ("tie-heavy", _tie_heavy_unit)])
@pytest.mark.parametrize("backend", ["int8", "int8-kernel"])
def test_int8_recall_contract_on_kb_grid(kind, make_kb, backend):
    """tests/test_quantized.py's contract: recall@k >= 0.95 against the fp32
    scan on every KB kind, for the full scan and the gathered scan."""
    recalls = []
    for n, d, k in [(256, 16, 8), (1024, 32, 10)]:
        rng = np.random.default_rng((sum(kind.encode()) * 1000003 + n) % 2**31)
        emb = make_kb(rng, n, d)
        exact = FlatBackend(emb)
        quant = make_backend(backend, emb, device="cpu")
        assert quant.exact is False and exact.exact is True
        for B in (1, 8):
            qs = _unit(rng, B, d)
            recalls.append(_recall(quant.search(qs, k)[0], exact.search(qs, k)[0]))
            cand = _ragged_cand(rng, B, 64, n)
            recalls.append(_recall(quant.search_gathered(qs, cand, k)[0],
                                   exact.search_gathered(qs, cand, k)[0]))
    mean = float(np.mean(recalls))
    assert mean >= 0.95, f"{backend} on {kind}: mean recall {mean:.3f} < 0.95"


def test_gathered_scratch_accounting():
    """The kernel backends report what their wrapper allocates: on the CPU
    the plain version's fp32 (B, C, d) gather over the resident rows, which
    are zero-padded to a multiple of 4 (fp32) or 16 (int8) columns at
    upload; the pre-gathered baseline is the slab at the KB's own width and
    the resident dtype; kb_bytes is what is resident."""
    for d, d4, d16 in ((16, 16, 16), (50, 52, 64)):
        emb = _grid(np.random.default_rng(1), 64, d)
        kern = TorchKernelBackend(emb, device="cpu")
        quant = TorchQuantizedKernelBackend(emb, device="cpu")
        assert kern.gathered_scratch_bytes(3, 40) == 3 * 40 * d4 * 4
        assert quant.gathered_scratch_bytes(3, 40) == 3 * 40 * d16 * 4
        assert kern.pregathered_scratch_bytes(3, 40) == 3 * 40 * d * 4
        assert quant.pregathered_scratch_bytes(3, 40) == 3 * 40 * (d + 4)
        assert kern.kb_bytes == 64 * d4 * 4 and quant.kb_bytes == 64 * d16 + 64 * 4


@pytest.mark.parametrize("d", [6, 50])
def test_kernel_backends_serve_any_d_and_k(d):
    """C1: the kernel backends take any d (KB padded once at upload, queries
    per call) and any k: on the CPU (the kernels' plain versions) at d = 6
    and 50, k = 20, 300 and N, they equal the reference's numpy backends
    byte for byte, the full scans and the gathered scans."""
    rng = np.random.default_rng(d)
    n = 3000
    emb = _tie_heavy(rng, n, d)
    ref, kern = RefFlat(emb), TorchKernelBackend(emb, device="cpu")
    qref, qkern = RefQuantFlat(emb), TorchQuantizedKernelBackend(emb, device="cpu")
    qs = _grid(rng, 3, d)
    cand = _ragged_cand(rng, 3, 700, n).astype(np.int64)
    for k in (20, 300, n):
        for want, got in ((ref.search(qs, k), kern.search(qs, k)),
                          (qref.search(qs, k), qkern.search(qs, k)),
                          (ref.search_gathered(qs, cand, k), kern.search_gathered(qs, cand, k)),
                          (qref.search_gathered(qs, cand, k),
                           qkern.search_gathered(qs, cand, k))):
            assert np.array_equal(want[0], got[0]) and np.array_equal(want[1], got[1]), k


def test_make_backend_and_retriever():
    emb = _grid(np.random.default_rng(2), 32, 8)
    assert BACKENDS == ("numpy", "kernel", "sharded", "int8", "int8-kernel",
                        "int8-sharded")
    assert make_backend("numpy", emb).name == "numpy"
    kern = make_backend("kernel", emb, device="cpu")
    assert kern.name == "kernel" and kern.exact and kern.kb_bytes == emb.nbytes
    assert make_backend("int8", emb).name == "int8"
    assert make_backend("int8-kernel", emb, device="cpu").name == "int8-kernel"
    for name in ("sharded", "int8-sharded"):
        b = make_backend(name, emb, n_shards=2, device="cpu")
        assert b.name == name and b.n_shards == 2
        assert np.array_equal(b.search(emb[:2], 5)[0], make_backend(
            name.replace("sharded", "kernel"), emb, device="cpu").search(emb[:2], 5)[0])
    with pytest.raises(KeyError, match="known"):
        make_backend("faiss", emb)
    ids, sc = kern.search_gathered(emb[:1], np.asarray([[3, 5, -1, -1]]), 3)
    assert ids.tolist() == [sorted([3, 5], key=lambda i: -float(emb[0] @ emb[i]))
                            + [-1]] and sc[0, 2] == -np.inf
    kb = DenseKB(embeddings=emb, docs=[[i] for i in range(32)])
    r = ExactDenseRetriever(kb, backend="kernel", device="cpu")
    ids, _ = r.retrieve(emb[3], 1)
    assert ids.shape == (1, 1) and r.stats.calls == 1 and r.backend.calls == 1
