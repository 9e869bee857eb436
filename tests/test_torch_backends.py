"""The port's EDR backends held against the reference ``FlatBackend``.

``TorchKernelBackend`` (on the CPU: the dense top-k kernel's plain version),
the port's ``FlatBackend`` and the reference's ``FlatBackend`` must agree byte
for byte — ids AND scores — on the grid-quantized, tie-heavy KBs of
tests/test_backends.py (every dot product exact in fp32, so only the
canonical tie order tells results apart), across batch sizes and k, KB sizes
that divide no block, and k > N.
"""
import numpy as np
import pytest

from repro.retrieval.backends import FlatBackend as RefFlat
from repro_torch.retrieval.backends import (BACKENDS, FlatBackend,
                                            TorchKernelBackend, canonical_topk,
                                            make_backend)
from repro_torch.retrieval.kb import DenseKB
from repro_torch.retrieval.retrievers import ExactDenseRetriever


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


def test_make_backend_and_retriever():
    emb = _grid(np.random.default_rng(2), 32, 8)
    assert BACKENDS == ("numpy", "kernel")
    assert make_backend("numpy", emb).name == "numpy"
    kern = make_backend("kernel", emb, device="cpu")
    assert kern.name == "kernel" and kern.exact and kern.kb_bytes == emb.nbytes
    with pytest.raises(KeyError):
        make_backend("int8", emb)
    with pytest.raises(NotImplementedError, match="ADR"):
        kern.search_gathered(emb[:1], np.zeros((1, 4), np.int64), 2)
    kb = DenseKB(embeddings=emb, docs=[[i] for i in range(32)])
    r = ExactDenseRetriever(kb, backend="kernel", device="cpu")
    ids, _ = r.retrieve(emb[3], 1)
    assert ids.shape == (1, 1) and r.stats.calls == 1 and r.backend.calls == 1
