"""The port's kernel modules held against the JAX Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; here those plain
versions meet the reference's Pallas kernels run in interpret mode (as
tests/test_kernels.py runs them). Inputs come from numpy with a seed and go
to both packages. Tolerances:
  * B1 dense top-k, B4-B8 gathered and int8 scans: byte equality of ids and
    scores on grid-quantized KBs (entries in multiples of 1/2, so every dot
    product is exact in fp32 in any summation order, the int8 scale multiply
    is one rounding, and only the tie order can tell results apart); on
    Gaussian inputs atol = rtol = 1e-4 with equal ids, the reference suite's
    own tolerance for its kernels against their oracles;
  * B2/B3 attention: allclose at 1e-5 — fp32 online softmax (Pallas) against
    one-shot softmax (plain), a few ulp apart.
The kernel-versus-plain tests need a CUDA device; they live in
tests/test_torch_gpu.py, which imports no JAX so it can run on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import decode_attention_pallas
from repro.kernels.dense_topk import (dense_topk_pallas,
                                      fused_gathered_topk_pallas,
                                      gathered_topk_pallas,
                                      quant_fused_gathered_topk_pallas,
                                      quant_gathered_topk_pallas,
                                      quant_topk_pallas)
from repro.kernels.prefill_attention import prefill_attention_pallas
from repro.retrieval.backends import quantize_kb
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import dense_topk as DT
from repro_torch.kernels import gathered_topk as GT
from repro_torch.kernels import prefill_attention as PA
from repro_torch.kernels import quant_topk as QT

# six xdist workers share the host's cores: one torch thread each
torch.set_num_threads(1)


def _grid(rng, n, d):
    return rng.integers(-2, 3, size=(n, d)).astype(np.float32) / 2


def _tie_heavy(rng, n, d):
    base = _grid(rng, max(n // 8, 2), d)
    return np.tile(base, (-(-n // base.shape[0]), 1))[:n]


# ---------------------------------------------------------------------------------
# B1 dense top-k
# ---------------------------------------------------------------------------------
@pytest.mark.parametrize("n,d,ties", [(130, 8, False), (257, 32, True),
                                      (1100, 16, True)])
def test_dense_topk_plain_matches_pallas_bytes(n, d, ties):
    """N a multiple of no block (block_n 256 here), tie-heavy KBs: ids AND
    scores byte-identical to the Pallas kernel, canonical order included."""
    rng = np.random.default_rng(n + d)
    kb = _tie_heavy(rng, n, d) if ties else _grid(rng, n, d)
    q = _grid(rng, 5, d)
    for k in (1, 7, 33):
        s_r, i_r = dense_topk_pallas(jnp.asarray(q), jnp.asarray(kb), k,
                                     block_n=256, interpret=True)
        s_p, i_p = DT.dense_topk(torch.from_numpy(q), torch.from_numpy(kb), k)
        assert i_p.dtype == torch.int32 and s_p.dtype == torch.float32
        assert np.array_equal(np.asarray(i_r), i_p.numpy()), f"k={k} ids"
        assert np.array_equal(np.asarray(s_r), s_p.numpy()), f"k={k} scores"


def test_dense_topk_batch_invariant_rows():
    """A query's row is the same whether it comes alone (RaLMSeq, B=1) or in
    a merged fleet call (B=12)."""
    rng = np.random.default_rng(4)
    kb = torch.from_numpy(_tie_heavy(rng, 500, 16))
    q = torch.from_numpy(_grid(rng, 12, 16))
    s12, i12 = DT.dense_topk(q, kb, 20)
    for b in (0, 5, 11):
        s1, i1 = DT.dense_topk(q[b:b + 1], kb, 20)
        assert torch.equal(s1[0], s12[b]) and torch.equal(i1[0], i12[b])


def test_dense_topk_rejects_bad_k():
    kb = torch.zeros((10, 4))
    with pytest.raises(ValueError):
        DT.dense_topk(torch.zeros((1, 4)), kb, 11)
    with pytest.raises(ValueError):
        DT.dense_topk(torch.zeros((1, 4)), kb, 0)


@pytest.mark.parametrize("B", [1, 12, 64])
@pytest.mark.parametrize("k", [1, 20, 256, 257, 20_000])
@pytest.mark.parametrize("N", [1, 255, 256, 257, 33_792, 500_000])
def test_scan_scratch_follows_the_list_count(B, k, N):
    """B1/B6 scratch: for k <= 256 one partial list of k keys per query from
    each scan CTA (one per SM, none without a 256-row tile), plus the merge's
    room; above it every row's key, plus a device-memory sort region when
    the top k (rounded up to a power of two) passes 16384 keys."""
    for sms in (132, 7):
        lists, nbytes = DT.scan_scratch(B, N, k, sms)
        assert lists == max(1, min(-(-N // DT.TILE_ROWS), sms))
        assert 1 <= lists <= sms and (lists - 1) * DT.TILE_ROWS < N
        if k <= DT.MAX_K:
            assert nbytes == 8 * B * k * (lists + -(-lists // 8))
        else:
            P = 1 << (min(k, N) - 1).bit_length()
            assert P >= min(k, N) and nbytes == 8 * B * (N + (P if P > 16384 else 0))
    assert DT.scan_scratch(B, N, k, 132)[0] == (132 if N > 131 * 256 else -(-N // 256))


@pytest.mark.parametrize("B,C,k", [(1, 62_500, 1), (1, 62_500, 20), (12, 62_500, 20),
                                   (12, 700, 256), (64, 62_500, 1), (200, 1300, 20),
                                   (3, 1300, 300), (2, 40_000, 40_000)])
def test_gathered_scratch_shares_the_sms_among_queries(monkeypatch, B, C, k):
    """B4/B5/B7/B8 scratch is computed in Python without the library: the
    CTAs, two per SM, are shared among the B queries, with at most two
    256-column tiles each (none without a tile), the lists and keys as the
    full scans'."""
    from repro_torch.kernels import _build
    monkeypatch.setattr(_build, "library", lambda name: pytest.fail("loaded the library"))
    lists, nbytes = DT.scan_scratch(B, C, k, 132, per_query=True)
    tiles = -(-C // 256)
    assert lists == max(1, min(tiles, max(264 // B, -(-tiles // 2))))
    assert -(-tiles // lists) <= 2 and (lists - 1) * 256 < C
    if k <= DT.MAX_K:
        assert nbytes == 8 * B * k * (lists + -(-lists // 8))
    else:
        P = 1 << (min(k, C) - 1).bit_length()
        assert nbytes == 8 * B * (C + (P if P > 16384 else 0))
    if (B, C) == (1, 62_500):
        assert lists == 245               # RaLMSeq's probe: one tile per CTA


def _kernel_path(monkeypatch):
    """Make the wrappers take their kernel path on CPU tensors: the checks
    before a launch run, and a launch would fail (no CUDA library here)."""
    from repro_torch.kernels import _build
    monkeypatch.setattr(_build, "on_cpu", lambda *_: False)
    monkeypatch.setattr(_build, "library", lambda name: pytest.fail("reached the launch"))


def _record_launches(monkeypatch):
    """Make the scan wrappers take their kernel path on CPU tensors and
    record each launch (entry, input shapes, int sizes, k) instead of
    making it."""
    from repro_torch.kernels import _build
    calls = []

    def launch(lib, entry, tensors, sizes, B, ncols, k, per_query=False):
        calls.append((entry, [tuple(t.shape) for t in tensors], tuple(sizes), k))
        return torch.zeros((B, k)), torch.zeros((B, k), dtype=torch.int32)
    monkeypatch.setattr(_build, "on_cpu", lambda *_: False)
    for mod in (DT, QT, GT):
        monkeypatch.setattr(mod, "launch", launch)
    return calls


@pytest.mark.parametrize("case", ["k", "d", "dtype", "contiguous"])
def test_scan_wrappers_refuse_what_the_kernel_does_not_take(monkeypatch, case):
    """B1 and B6 refuse a wrong dtype and non-contiguous input before any
    launch. They take k > 256 (the key pass and the select pass) and any d:
    queries and rows reach the launch zero-padded to a multiple of the
    16-byte copy (4 fp32, 16 int8 elements)."""
    calls = _record_launches(monkeypatch)
    d, k = (6 if case == "d" else 16), (257 if case == "k" else 4)
    q = torch.zeros((2, d), dtype=torch.float64 if case == "dtype" else torch.float32)
    kb = torch.zeros((300, d))
    codes = torch.zeros((300, d + 2 if case == "d" else d), dtype=torch.int8)
    if case == "contiguous":
        kb, codes = torch.zeros((d, 300)).T, torch.zeros((d, 300), dtype=torch.int8).T
    qq = torch.zeros((2, codes.shape[1]), dtype=q.dtype)
    if case in ("dtype", "contiguous"):
        err = TypeError if case == "dtype" else ValueError
        with pytest.raises(err):
            DT.dense_topk(q, kb, k)
        with pytest.raises(err):
            QT.quant_dense_topk(qq, codes, torch.ones(300), k)
        assert calls == []
        return
    DT.dense_topk(q, kb, k)
    QT.quant_dense_topk(qq, codes, torch.ones(300), k)
    d4, d16 = (8, 16) if case == "d" else (16, 16)
    assert calls == [("dense_topk_launch", [(2, d4), (300, d4)], (2, 300, d4, k), k),
                     ("quant_topk_launch", [(2, d16), (300, d16), (300,)], (2, 300, d16, k), k)]


@pytest.mark.parametrize("d,k", [(50, 20), (64, 300), (6, 1300)])
def test_gathered_wrappers_pad_d_and_take_any_k(monkeypatch, d, k):
    """The four gathered wrappers reach their launch with q and rows
    zero-padded to a multiple of 4 (fp32) or 16 (int8) elements, and at any
    k >= 1 (k > 256: the key pass and the select pass; k > C: pads)."""
    calls = _record_launches(monkeypatch)
    B, C, N = 3, 1300, 3001
    q, cand = torch.zeros((B, d)), torch.zeros((B, C), dtype=torch.int32)
    GT.fused_gathered_topk(q, torch.zeros((N, d)), cand, k)
    GT.gathered_topk(q, torch.zeros((B, C, d)), cand, k)
    GT.quant_fused_gathered_topk(q, torch.zeros((N, d), dtype=torch.int8), torch.ones(N), cand, k)
    GT.quant_gathered_topk(q, torch.zeros((B, C, d), dtype=torch.int8), torch.ones((B, C)),
                           cand, k)
    d4, d16 = -(-d // 4) * 4, -(-d // 16) * 16
    assert calls == [
        ("fused_gathered_topk_launch", [(B, d4), (N, d4), (B, C)], (B, N, C, d4, k), k),
        ("gathered_topk_launch", [(B, d4), (B, C, d4), (B, C)], (B, C, d4, k), k),
        ("quant_fused_gathered_topk_launch", [(B, d16), (N, d16), (N,), (B, C)],
         (B, N, C, d16, k), k),
        ("quant_gathered_topk_launch", [(B, d16), (B, C, d16), (B, C), (B, C)],
         (B, C, d16, k), k)]
    assert all(GT.launches[n] > 0 for n in GT.launches)


@pytest.mark.parametrize("case", ["hd", "dtype", "contiguous"])
def test_prefill_wrapper_refuses_what_the_kernel_does_not_take(monkeypatch, case):
    """A wrong dtype, non-contiguous input, and k whose head dim is not q's
    raise before any launch. Every hd itself is taken, above the widest
    kernel instance (256) too (the wide-head kernel; ROADMAP fault C3)."""
    _kernel_path(monkeypatch)
    hd = 264 if case == "hd" else 64
    q = torch.zeros((1, 8, 4, hd), dtype=torch.float64 if case == "dtype" else torch.float32)
    k = torch.zeros((1, 8, 2, hd + 4 if case == "hd" else hd))
    if case == "contiguous":
        k = torch.zeros((1, 2, 8, hd)).transpose(1, 2)
    with pytest.raises(TypeError if case == "dtype" else ValueError):
        PA.prefill_attention(q, k, k)


# ---------------------------------------------------------------------------------
# B4, B5, B7, B8 gathered scans and B6 int8 scan
# ---------------------------------------------------------------------------------
def _ragged_cand(rng, B, C, N, dup_row=None, empty_row=None):
    """Id-sorted candidate rows with -1 tail padding (as the IVF probe hands
    them in); optionally one row with a duplicated id and one all-pad row."""
    cand = np.full((B, C), -1, np.int32)
    for b in range(B):
        if b == empty_row:
            continue
        w = int(rng.integers(1, min(C, N)))
        row = np.sort(rng.choice(N, size=w, replace=False))
        if b == dup_row and w >= 2:
            row[1] = row[0]
        cand[b, :w] = row
    return cand


def _gathered_pair(kind, q, kb, cand, k):
    """One gathered scan through the Pallas kernel (interpret mode, small
    tiles so C crosses several) and through the port's wrapper (its plain
    version, the tensors being on the CPU)."""
    safe = np.maximum(cand, 0)
    jq, jc = jnp.asarray(q), jnp.asarray(cand)
    tq, tc = torch.from_numpy(q), torch.from_numpy(cand)
    if kind in ("B7", "B8"):
        codes, scales = quantize_kb(kb)
        if kind == "B7":
            ref = quant_fused_gathered_topk_pallas(jq, jnp.asarray(codes), jnp.asarray(scales),
                                                   jc, k, block_c=128, interpret=True)
            out = GT.quant_fused_gathered_topk(tq, torch.from_numpy(codes),
                                               torch.from_numpy(scales), tc, k)
        else:
            ref = quant_gathered_topk_pallas(jq, jnp.asarray(codes[safe]),
                                             jnp.asarray(scales[safe]), jc, k,
                                             block_c=128, interpret=True)
            out = GT.quant_gathered_topk(tq, torch.from_numpy(codes[safe]),
                                         torch.from_numpy(scales[safe]), tc, k)
    elif kind == "B4":
        ref = fused_gathered_topk_pallas(jq, jnp.asarray(kb), jc, k, block_c=128,
                                         interpret=True)
        out = GT.fused_gathered_topk(tq, torch.from_numpy(kb), tc, k)
    else:
        ref = gathered_topk_pallas(jq, jnp.asarray(kb[safe]), jc, k, block_c=128,
                                   interpret=True)
        out = GT.gathered_topk(tq, torch.from_numpy(kb[safe]), tc, k)
    return (np.asarray(ref[0]), np.asarray(ref[1])), (out[0].numpy(), out[1].numpy())


@pytest.mark.parametrize("kind", ["B4", "B5", "B7", "B8"])
@pytest.mark.parametrize("B,N,C,d,k,dup,empty", [
    (3, 500, 130, 32, 5, 0, 2),       # C a multiple of no tile, duplicate id, all-pad row
    (3, 300, 384, 16, 8, None, None), # ids cross tile boundaries, 3 tiles
    (1, 128, 16, 8, 16, None, None),  # k > real candidates -> pad sentinels
])
def test_gathered_plain_matches_pallas_bytes(kind, B, N, C, d, k, dup, empty):
    """Tie-heavy grid KBs: ids AND scores byte-identical to the Pallas kernel,
    column tie order and (NEG, -1) pads included."""
    rng = np.random.default_rng(N + C + d)
    kb = _tie_heavy(rng, N, d)
    q = _grid(rng, B, d)
    cand = _ragged_cand(rng, B, C, N, dup_row=dup, empty_row=empty)
    (s_r, i_r), (s_p, i_p) = _gathered_pair(kind, q, kb, cand, k)
    assert i_p.dtype == np.int32 and s_p.dtype == np.float32
    assert np.array_equal(i_r, i_p), f"{kind} ids"
    assert np.array_equal(s_r, s_p), f"{kind} scores"
    if empty is not None:
        assert np.all(i_p[empty] == -1) and np.all(s_p[empty] == np.float32(DT.NEG))


@pytest.mark.parametrize("kind", ["B4", "B5", "B7", "B8"])
@pytest.mark.parametrize("B,N,C,d,k", [(2, 500, 130, 32, 5), (3, 300, 270, 16, 6)])
def test_gathered_plain_matches_pallas_gaussian(kind, B, N, C, d, k):
    rng = np.random.default_rng(B * N + C)
    kb = rng.standard_normal((N, d)).astype(np.float32)
    q = rng.standard_normal((B, d)).astype(np.float32)
    cand = _ragged_cand(rng, B, C, N, dup_row=0)
    (s_r, i_r), (s_p, i_p) = _gathered_pair(kind, q, kb, cand, k)
    np.testing.assert_allclose(s_p, s_r, atol=1e-4, rtol=1e-4)
    assert np.array_equal(i_r, i_p)


def test_gathered_fused_equals_pregathered_and_batch_invariant():
    """B4 == B5 and B7 == B8 byte for byte; a query's row is the same alone
    (B=1) and in a batch of 12; k > C pads with (NEG, -1)."""
    rng = np.random.default_rng(11)
    N, C, d = 400, 300, 32
    kb = _tie_heavy(rng, N, d)
    codes, scales = (torch.from_numpy(a) for a in quantize_kb(kb))
    kb = torch.from_numpy(kb)
    q = torch.from_numpy(_grid(rng, 12, d))
    cand = torch.from_numpy(_ragged_cand(rng, 12, C, N, dup_row=1, empty_row=4))
    safe = cand.clamp(min=0).long()
    for k in (1, 20, 256):
        b4 = GT.fused_gathered_topk(q, kb, cand, k)
        b5 = GT.gathered_topk(q, kb[safe], cand, k)
        b7 = GT.quant_fused_gathered_topk(q, codes, scales, cand, k)
        b8 = GT.quant_gathered_topk(q, codes[safe], scales[safe], cand, k)
        for x, y in ((b4, b5), (b7, b8)):
            assert torch.equal(x[0], y[0]) and torch.equal(x[1], y[1])
        for b in (0, 4, 11):
            one = GT.fused_gathered_topk(q[b:b + 1], kb, cand[b:b + 1], k)
            assert torch.equal(one[0][0], b4[0][b]) and torch.equal(one[1][0], b4[1][b])
        if k > C:
            assert (b4[1][:, C:] == -1).all() and (b7[0][:, C:] == DT.NEG).all()


@pytest.mark.parametrize("B,N,d,k,ties", [
    (1, 257, 32, 1, False), (4, 1000, 64, 8, True), (3, 130, 16, 4, False),
    (2, 700, 16, 6, True)])
def test_quant_topk_plain_matches_pallas(B, N, d, k, ties):
    """B6 on grid KBs (byte-identical) and on Gaussian KBs (1e-4, equal ids),
    several KB tiles so ids cross tile boundaries."""
    rng = np.random.default_rng(B * N + k)
    for emb, exact in ((_tie_heavy(rng, N, d) if ties else _grid(rng, N, d), True),
                       (rng.standard_normal((N, d)).astype(np.float32), False)):
        q = _grid(rng, B, d) if exact else rng.standard_normal((B, d)).astype(np.float32)
        codes, scales = quantize_kb(emb)
        s_r, i_r = quant_topk_pallas(jnp.asarray(q), jnp.asarray(codes),
                                     jnp.asarray(scales), k, block_n=256, interpret=True)
        s_p, i_p = QT.quant_dense_topk(torch.from_numpy(q), torch.from_numpy(codes),
                                       torch.from_numpy(scales), k)
        assert i_p.dtype == torch.int32 and np.array_equal(np.asarray(i_r), i_p.numpy())
        if exact:
            assert np.array_equal(np.asarray(s_r), s_p.numpy())
        else:
            np.testing.assert_allclose(s_p.numpy(), np.asarray(s_r), atol=1e-4, rtol=1e-4)


def test_fused_scans_read_no_row_past_n():
    """An id at or past the KB's N rows is not read: it scores NEG, as a pad
    does, and keeps its id; the real candidates rank as before."""
    rng = np.random.default_rng(6)
    kb = torch.from_numpy(_grid(rng, 50, 16))
    codes, scales = (torch.from_numpy(a) for a in quantize_kb(kb.numpy()))
    q = torch.from_numpy(_grid(rng, 1, 16))
    cand = torch.tensor([[3, 7, 50, 99, -1]], dtype=torch.int32)
    for s, i in (GT.fused_gathered_topk(q, kb, cand, 5),
                 GT.quant_fused_gathered_topk(q, codes, scales, cand, 5)):
        assert sorted(i[0, :2].tolist()) == [3, 7] and i[0, 2:].tolist() == [50, 99, -1]
        assert (s[0, 2:] == DT.NEG).all()


@pytest.mark.parametrize("d", [6, 50, 64])
def test_pad_d_keeps_every_score(d):
    """The kernels' d padding (zero columns up to a multiple of 4 fp32 or 16
    int8 elements) changes no result: every plain version on padded queries
    and rows equals it on the originals byte for byte, on a tie-heavy grid
    KB, fp32 and int8, full and gathered scans; a multiple is not copied."""
    rng = np.random.default_rng(d)
    N, B, C = 700, 5, 300
    kb = torch.from_numpy(_tie_heavy(rng, N, d))
    q = torch.from_numpy(_grid(rng, B, d))
    codes, scales = (torch.from_numpy(a) for a in quantize_kb(kb.numpy()))
    cand = torch.from_numpy(_ragged_cand(rng, B, C, N, dup_row=0, empty_row=2))
    safe = cand.clamp(min=0).long()
    for m in (4, 16):
        pq, pkb, pcodes = DT.pad_d(q, m), DT.pad_d(kb, m), DT.pad_d(codes, m)
        assert pq.shape[1] % m == 0 and pq.shape[1] - d < m and pcodes.dtype == torch.int8
        assert torch.equal(pq[:, :d], q) and not pq[:, d:].any() and not pcodes[:, d:].any()
        pairs = [(DT.dense_topk_plain(q, kb, 40), DT.dense_topk_plain(pq, pkb, 40)),
                 (QT.quant_dense_topk_plain(q, codes, scales, 40),
                  QT.quant_dense_topk_plain(pq, pcodes, scales, 40)),
                 (GT.fused_gathered_topk_plain(q, kb, cand, 40),
                  GT.fused_gathered_topk_plain(pq, pkb, cand, 40)),
                 (GT.gathered_topk_plain(q, kb[safe], cand, 40),
                  GT.gathered_topk_plain(pq, DT.pad_d(kb[safe], m), cand, 40)),
                 (GT.quant_fused_gathered_topk_plain(q, codes, scales, cand, 40),
                  GT.quant_fused_gathered_topk_plain(pq, pcodes, scales, cand, 40)),
                 (GT.quant_gathered_topk_plain(q, codes[safe], scales[safe], cand, 40),
                  GT.quant_gathered_topk_plain(pq, DT.pad_d(codes[safe], m), scales[safe],
                                               cand, 40))]
        for (s0, i0), (s1, i1) in pairs:
            assert torch.equal(s0, s1) and torch.equal(i0, i1)
    p16 = DT.pad_d(q, 16)
    assert DT.pad_d(p16, 4) is p16


def test_gathered_and_quant_wrappers_reject_bad_inputs():
    q, cand = torch.zeros((2, 8)), torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="k=0"):
        GT.fused_gathered_topk(q, torch.zeros((10, 8)), cand, 0)
    with pytest.raises(ValueError, match="shapes"):
        GT.fused_gathered_topk(q, torch.zeros((10, 6)), cand, 1)
    with pytest.raises(ValueError, match="emb"):
        GT.gathered_topk(q, torch.zeros((2, 5, 8)), cand, 1)
    with pytest.raises(ValueError, match="several devices"):
        GT.fused_gathered_topk(q, torch.zeros((10, 8), device="meta"), cand, 1)
    with pytest.raises(ValueError, match="outside"):
        QT.quant_dense_topk(q, torch.zeros((3, 8), dtype=torch.int8), torch.ones(3), 4)


# ---------------------------------------------------------------------------------
# B2 decode attention
# ---------------------------------------------------------------------------------
@pytest.mark.parametrize("B,H,KV,hd,W", [(3, 4, 4, 32, 64), (2, 8, 2, 16, 130),
                                         (4, 8, 1, 64, 257),
                                         # a fifth row at cache_len 0 (W a multiple of
                                         # block_w: the Pallas kernel pads the window)
                                         (5, 4, 4, 32, 128),
                                         # 12 query heads per KV head
                                         (5, 24, 2, 16, 128), (3, 24, 2, 16, 130)])
def test_decode_attention_plain_matches_pallas(B, H, KV, hd, W):
    """GQA groups, per-row cache_len, ring slots past cache_len masked; a row
    at cache_len 0 has every slot masked, so its output is the mean of v over
    the window."""
    rng = np.random.default_rng(B * W + H)
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    kc = rng.standard_normal((B, W, KV, hd)).astype(np.float32)
    vc = rng.standard_normal((B, W, KV, hd)).astype(np.float32)
    cl = np.asarray([1, W, W // 3, 7, 0][:B], np.int32)
    ref = decode_attention_pallas(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                                  jnp.asarray(cl), block_w=64, interpret=True)
    out = DA.decode_attention(torch.from_numpy(q), torch.from_numpy(kc),
                              torch.from_numpy(vc), torch.from_numpy(cl))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    if B == 5:
        np.testing.assert_allclose(out[4].numpy(), vc[4].mean(0).repeat(H // KV, 0),
                                   rtol=1e-5, atol=1e-5)


# ROADMAP fault C3: B2 and B3 at the head dims of the repo's configs and of
# reduced() (kimi-k2's 112, paligemma's and xlstm's 256, reduced 16 and 32),
# and above the widest kernel instance (264 and 512: the wide-head kernel)
@pytest.mark.parametrize("hd", [16, 32, 112, 256, 264, 512])
def test_decode_attention_plain_matches_pallas_at_every_head_dim(hd):
    """GQA 8 / 1 (paligemma's), per-row cache_len with a 0 row (the mean of
    v over the window) and a row past the window."""
    B, H, KV, W = 4, 8, 1, 96
    rng = np.random.default_rng(hd)
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    kc = rng.standard_normal((B, W, KV, hd)).astype(np.float32)
    vc = rng.standard_normal((B, W, KV, hd)).astype(np.float32)
    cl = np.asarray([1, 65, 0, W + 9], np.int32)
    ref = decode_attention_pallas(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                                  jnp.asarray(cl), block_w=32, interpret=True)
    out = DA.decode_attention(torch.from_numpy(q), torch.from_numpy(kc),
                              torch.from_numpy(vc), torch.from_numpy(cl))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("hd", [16, 32, 112, 256, 264, 512])
@pytest.mark.parametrize("window,prefix", [(0, 0), (24, 0), (0, 19)])
def test_prefill_attention_plain_matches_pallas_at_every_head_dim(hd, window, prefix):
    """Causal, sliding window and bidirectional prefix, 8 query heads over
    one KV head."""
    B, S, H, KV = 1, 70, 8, 1
    rng = np.random.default_rng(hd + window + prefix)
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    kw = dict(causal=True, window=window, prefix_len=prefix)
    ref = prefill_attention_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   bq=32, bk=32, interpret=True, **kw)
    out = PA.prefill_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("hd,instance", [(16, 16), (40, 64), (112, 112), (200, 256),
                                         (6, 16), (264, 264), (266, 268), (512, 512)])
def test_attention_wrappers_pad_hd_to_a_kernel_instance(monkeypatch, hd, instance):
    """On the kernel path every hd reaches a launch: the kernels' own widths
    as they are, any other hd <= 256 zero-padded to the next instance, and
    above 256 (the wide-head kernel) to a multiple of 4, with the softmax
    scale of the real hd; the output comes back at hd."""
    from repro_torch.kernels import _build
    seen = []

    class Lib:
        def __getattr__(self, entry):
            def launch(*args):
                seen.append((entry, args))
                return 0
            launch.argtypes = None
            return launch
    monkeypatch.setattr(_build, "on_cpu", lambda *_: False)
    monkeypatch.setattr(_build, "library", lambda name: Lib())
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    monkeypatch.setattr(DA, "_scratch_for", lambda *a: (None, None, 0, 0, 0, 0))
    monkeypatch.setattr(PA, "_fn", None)
    q, kc = torch.zeros((2, 4, hd)), torch.zeros((2, 9, 2, hd))
    out = DA.decode_attention(q, kc, kc, torch.ones(2, dtype=torch.int32))
    assert out.shape == (2, 4, hd)
    qs, ks = torch.zeros((1, 5, 4, hd)), torch.zeros((1, 5, 2, hd))
    out = PA.prefill_attention(qs, ks, ks)
    assert out.shape == (1, 5, 4, hd)
    (e1, a1), (e2, a2) = seen
    assert e1 == "decode_attention_launch" and a1[11] == instance
    assert e2 == "prefill_attention_launch" and a2[8] == instance
    assert a1[12] == a2[12] == pytest.approx(1.0 / np.sqrt(hd), rel=1e-12)


def test_decode_attention_ignores_slots_past_cache_len():
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((1, 2, 16)).astype(np.float32))
    kc = torch.from_numpy(rng.standard_normal((1, 64, 2, 16)).astype(np.float32))
    vc = torch.from_numpy(rng.standard_normal((1, 64, 2, 16)).astype(np.float32))
    cl = torch.tensor([17], dtype=torch.int32)
    o1 = DA.decode_attention(q, kc, vc, cl)
    kc2, vc2 = kc.clone(), vc.clone()
    kc2[:, 17:] = 99.0
    vc2[:, 17:] = -99.0
    o2 = DA.decode_attention(q, kc2, vc2, cl)
    assert torch.equal(o1, o2)


# ---------------------------------------------------------------------------------
# B3 prefill attention
# ---------------------------------------------------------------------------------
@pytest.mark.parametrize("B,S,H,KV,hd,causal,window,prefix", [
    (1, 130, 4, 4, 32, True, 0, 0),
    (2, 100, 4, 2, 16, True, 0, 0),       # GQA
    (1, 150, 4, 4, 16, True, 40, 0),      # sliding window
    (1, 120, 4, 1, 32, True, 0, 37),      # bidirectional prefix
    (1, 90, 4, 2, 16, False, 0, 0),       # bidirectional
])
def test_prefill_attention_plain_matches_pallas(B, S, H, KV, hd, causal, window,
                                                prefix):
    rng = np.random.default_rng(S + H + window + prefix)
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    kw = dict(causal=causal, window=window, prefix_len=prefix)
    ref = prefill_attention_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   bq=64, bk=64, interpret=True, **kw)
    out = PA.prefill_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_wrappers_reject_mixed_devices():
    t = torch.zeros((1, 4))
    with pytest.raises(ValueError):
        DT.dense_topk(t, torch.zeros((4, 4), device="meta"), 1)
