"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here carries the ``gpu`` marker and skips without a CUDA device.
The file imports no JAX, so it runs on a machine that has only the port's
dependencies (there the JAX conftest cannot load):

    PYTHONPATH=src python3 -m pytest -q --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Tolerances: byte equality for the dense top-k, the gathered scans and the
int8 scan on grid-quantized KBs (every dot product exact in fp32, the int8
scale one rounding); 2e-5 absolute for attention (fp32 chunked softmax in the
kernel against one-shot softmax in the plain version).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import dense_topk as DT
from repro_torch.kernels import gathered_topk as GT
from repro_torch.kernels import prefill_attention as PA
from repro_torch.kernels import quant_topk as QT
from repro_torch.retrieval.backends import (FlatBackend, QuantizedFlatBackend,
                                            TorchKernelBackend,
                                            TorchQuantizedKernelBackend, quantize_kb)

# six xdist workers share the host's cores: one torch thread each
torch.set_num_threads(1)

pytestmark = pytest.mark.gpu


def _grid(rng, n, d):
    return rng.integers(-2, 3, size=(n, d)).astype(np.float32) / 2


def _tie_heavy(rng, n, d):
    base = _grid(rng, max(n // 8, 2), d)
    return np.tile(base, (-(-n // base.shape[0]), 1))[:n]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.mark.parametrize("kind", ["grid", "unit"])
@pytest.mark.parametrize("N", [3001, 100, 70_001])    # a multiple of no tile, < one
@pytest.mark.parametrize("k", [1, 20, 256])           # tile, more tiles than SMs
def test_dense_topk_kernel_matches_plain(cuda, kind, N, k):
    """B=1, 12 and 64 (every query-block width): on a tie-heavy grid KB the
    kernel equals the plain version byte for byte; on a unit-normal KB its
    scores are within 1e-5 of the plain version's; on both the B=1 and B=12
    rows equal the B=64 rows byte for byte."""
    rng = np.random.default_rng(N + k)
    k = min(k, N)
    make = _tie_heavy if kind == "grid" else _unit
    kb = torch.from_numpy(make(rng, N, 64)).to(cuda)
    q = torch.from_numpy((_grid if kind == "grid" else _unit)(rng, 64, 64)).to(cuda)
    rows = {}
    for B in (64, 12, 1):
        before = DT.launches
        rows[B] = DT.dense_topk(q[:B], kb, k)
        assert DT.launches == before + 1
        s_p, i_p = DT.dense_topk_plain(q[:B], kb, k)
        if kind == "grid":
            assert torch.equal(rows[B][0], s_p) and torch.equal(rows[B][1], i_p)
        else:
            torch.testing.assert_close(rows[B][0], s_p, rtol=0, atol=1e-5)
        assert torch.equal(rows[B][0], rows[64][0][:B]) and torch.equal(rows[B][1], rows[64][1][:B])


def _decode_inputs(cuda, seed, lens, W, H, KV, hd):
    g = torch.Generator(device=cuda).manual_seed(seed)
    B = len(lens)
    q = torch.randn((B, H, hd), generator=g, device=cuda)
    kc = torch.randn((B, W, KV, hd), generator=g, device=cuda)
    vc = torch.randn((B, W, KV, hd), generator=g, device=cuda)
    return q, kc, vc, torch.tensor(lens, dtype=torch.int32, device=cuda)


def _chunk_edges(W):
    """cache_len 0, the chunk edges, the window, and past it."""
    S = DA.CHUNK
    return [0, 1, S - 1, S, S + 1, W, W + 9]


@pytest.mark.parametrize("H,KV,hd", [(16, 16, 64), (16, 4, 64), (8, 2, 128),
                                     (16, 16, 128), (16, 2, 64), (16, 2, 128),
                                     (24, 2, 64), (24, 2, 128)])
def test_decode_attention_kernel_matches_plain(cuda, H, KV, hd):
    """G = H / KV in {1, 4, 8, 12} at hd 64 and 128: the fleet's shape (W=512,
    lens 1, 97, 300, 512), then cache_len 0, the chunk edges, W and past W at
    W = 512 and at W = 300 and 513 (no multiple of the chunk); each call
    launches the kernel once and lands within 2e-5 of the plain version."""
    cases = [(512, [1, 97, 300, 512])] + [(W, _chunk_edges(W)) for W in (512, 300, 513)]
    for W, lens in cases:
        q, kc, vc, cl = _decode_inputs(cuda, H + KV + hd + W, lens, W, H, KV, hd)
        before = DA.launches
        out = DA.decode_attention(q, kc, vc, cl)
        assert DA.launches == before + 1
        torch.testing.assert_close(out, DA.decode_attention_plain(q, kc, vc, cl),
                                   rtol=0, atol=2e-5, msg=f"W={W} lens={lens}")


# ROADMAP fault C3: every head dim of the repo's configs and of reduced()
# (16, 32, 112, 256), two that pad to an instance (40 -> 64, 200 -> 256),
# and three above the widest instance (the wide-head kernel)
@pytest.mark.parametrize("hd", [16, 32, 112, 256, 40, 200, 264, 384, 512])
@pytest.mark.parametrize("H,KV", [(8, 1), (16, 4)])
def test_decode_attention_kernel_matches_plain_at_every_head_dim(cuda, hd, H, KV):
    """cache_len 0, the chunk edges, W and past W at W = 512 and 513, and
    the fleet's lengths at B=4: within 2e-5 of the plain version, one launch
    a call; each slot's row equals its B=1 call byte for byte."""
    cases = [(512, [1, 97, 300, 512])] + [(W, _chunk_edges(W)) for W in (512, 513)]
    for W, lens in cases:
        q, kc, vc, cl = _decode_inputs(cuda, H + KV + hd + W, lens, W, H, KV, hd)
        before = DA.launches
        out = DA.decode_attention(q, kc, vc, cl)
        assert DA.launches == before + 1
        torch.testing.assert_close(out, DA.decode_attention_plain(q, kc, vc, cl),
                                   rtol=0, atol=2e-5, msg=f"hd={hd} W={W} lens={lens}")
        for b in range(len(lens)):
            one = DA.decode_attention(q[b:b + 1], kc[b:b + 1], vc[b:b + 1],
                                      cl[b:b + 1].clone())
            assert torch.equal(one[0], out[b]), (hd, W, lens[b])


@pytest.mark.parametrize("H,KV,hd", [(16, 16, 64), (24, 2, 128)])
def test_decode_attention_rows_do_not_depend_on_the_batch(cuda, H, KV, hd):
    """Each slot's row of a batched call equals a B=1 call on that slot alone,
    byte for byte: the fleet's slots decode as RaLMSeq's single request does."""
    for W, lens in ((512, [1, 97, 300, 512]), (513, _chunk_edges(513))):
        q, kc, vc, cl = _decode_inputs(cuda, H + hd + W, lens, W, H, KV, hd)
        out = DA.decode_attention(q, kc, vc, cl)
        for b in range(len(lens)):
            one = DA.decode_attention(q[b:b + 1], kc[b:b + 1], vc[b:b + 1],
                                      cl[b:b + 1].clone())   # 16-byte aligned
            assert torch.equal(one[0], out[b]), (W, lens[b])


def test_decode_attention_repeats_to_the_byte(cuda):
    """Two calls on the same inputs give the same bytes whichever chunk
    combines, and every call leaves the ticket counters at zero."""
    lens = _chunk_edges(512) + [1, 97, 300, 512]
    q, kc, vc, cl = _decode_inputs(cuda, 21, lens, 512, 24, 2, 64)
    first = DA.decode_attention(q, kc, vc, cl)
    for _ in range(3):
        assert torch.equal(DA.decode_attention(q, kc, vc, cl), first)
    torch.cuda.synchronize()
    assert not DA._scratch[q.device.index][0].any()


@pytest.mark.parametrize("S,H,KV,hd,causal,window,prefix", [
    (112, 16, 16, 64, True, 0, 0), (300, 16, 16, 64, True, 0, 0),
    (300, 16, 16, 64, True, 64, 0), (200, 16, 16, 64, True, 0, 37),
    (160, 16, 4, 64, True, 0, 0), (70, 4, 2, 128, True, 0, 0),
    # the 16-row q tiles' and the k/v tiles' edges
    (1, 4, 4, 64, True, 0, 0), (15, 4, 2, 64, True, 8, 0), (16, 4, 4, 128, True, 0, 5),
    (17, 4, 1, 64, True, 0, 0), (33, 8, 2, 128, True, 16, 0), (33, 4, 4, 64, False, 0, 0),
    (300, 8, 2, 128, True, 0, 37), (513, 8, 8, 64, True, 100, 0),
    (513, 4, 2, 128, True, 0, 0)])
def test_prefill_attention_kernel_matches_plain(cuda, S, H, KV, hd, causal, window, prefix):
    """B=2 within 2e-5 of the plain version; each sequence's rows equal a
    B=1 call's byte for byte."""
    g = torch.Generator(device=cuda).manual_seed(S + H + hd)
    q = torch.randn((2, S, H, hd), generator=g, device=cuda)
    k = torch.randn((2, S, KV, hd), generator=g, device=cuda)
    v = torch.randn((2, S, KV, hd), generator=g, device=cuda)
    kw = dict(causal=causal, window=window, prefix_len=prefix)
    before = PA.launches
    out = PA.prefill_attention(q, k, v, **kw)
    assert PA.launches == before + 1
    torch.testing.assert_close(out, PA.prefill_attention_plain(q, k, v, **kw),
                               rtol=0, atol=2e-5)
    for b in range(2):
        assert torch.equal(PA.prefill_attention(q[b:b + 1], k[b:b + 1], v[b:b + 1], **kw)[0],
                           out[b])


@pytest.mark.parametrize("hd", [16, 32, 112, 256, 40, 200, 264, 384, 512])
@pytest.mark.parametrize("S,H,KV,window,prefix", [
    (160, 8, 1, 0, 0), (160, 8, 1, 64, 0), (160, 8, 1, 0, 37), (33, 16, 4, 0, 0),
    (1, 8, 1, 0, 0), (513, 4, 2, 100, 0)])
def test_prefill_attention_kernel_matches_plain_at_every_head_dim(cuda, hd, S, H, KV,
                                                                  window, prefix):
    """ROADMAP fault C3: B3 at the configs' head dims (two padded ones, and
    three above 256 through the wide-head kernel), causal, sliding window and
    prefix, paligemma's 8 / 1 heads: B=2 within
    2e-5 of the plain version, each sequence's rows equal to a B=1 call's."""
    g = torch.Generator(device=cuda).manual_seed(S + H + hd + window + prefix)
    q = torch.randn((2, S, H, hd), generator=g, device=cuda)
    k = torch.randn((2, S, KV, hd), generator=g, device=cuda)
    v = torch.randn((2, S, KV, hd), generator=g, device=cuda)
    kw = dict(causal=True, window=window, prefix_len=prefix)
    before = PA.launches
    out = PA.prefill_attention(q, k, v, **kw)
    assert PA.launches == before + 1
    torch.testing.assert_close(out, PA.prefill_attention_plain(q, k, v, **kw),
                               rtol=0, atol=2e-5)
    for b in range(2):
        assert torch.equal(PA.prefill_attention(q[b:b + 1], k[b:b + 1], v[b:b + 1], **kw)[0],
                           out[b])


def _same_bytes_alone_and_again(call, args, B):
    """The batched call's rows equal each sequence's B=1 call byte for byte,
    and a second batched call gives the same bytes."""
    out = call(*args)
    assert torch.equal(call(*args), out)
    for b in range(B):
        one = tuple(t[b:b + 1].clone() for t in args)      # 16-byte aligned
        assert torch.equal(call(*one)[0], out[b]), b
    return out


def _wide_decode_check(cuda, lens, W, H, KV, hd):
    q, kc, vc, cl = _decode_inputs(cuda, H + KV + hd + W, lens, W, H, KV, hd)
    before = DA.launches
    out = DA.decode_attention(q, kc, vc, cl)
    assert DA.launches == before + 1
    torch.testing.assert_close(out, DA.decode_attention_plain(q, kc, vc, cl),
                               rtol=0, atol=2e-5, msg=f"hd={hd} W={W} lens={lens}")
    assert torch.equal(_same_bytes_alone_and_again(DA.decode_attention, (q, kc, vc, cl),
                                                   len(lens)), out)
    torch.cuda.synchronize()
    assert not DA._scratch[q.device.index][0].any()


@pytest.mark.parametrize("hd", [512, 264])
def test_decode_wide_heads_at_twelve_heads_a_group(cuda, hd):
    """The wide-head B2 at G = 12 (24 / 2 heads: a pass of 16 heads holds the
    group): the fleet's lengths, then cache_len 0, the 32-entry chunk edges,
    W and past W; within 2e-5 of plain, rows equal to B=1 calls and to a
    repeated call, the tickets left at zero."""
    _wide_decode_check(cuda, [1, 97, 300, 512], 512, 24, 2, hd)
    _wide_decode_check(cuda, [0, 1, 31, 32, 33, 63, 64, 65, 512, 521], 512, 24, 2, hd)


@pytest.mark.parametrize("lens", [(16384, 9000), (1, 16384)])
def test_decode_wide_heads_merge_many_chunks(cuda, lens):
    """W = 16,384 at hd 512 (8 / 2 heads): 16,384 entries are 64 chunks of
    256, 9,000 are 57 of 160, so the merge runs over many partials."""
    _wide_decode_check(cuda, list(lens), 16384, 8, 2, 512)


@pytest.mark.parametrize("S,H,KV,hd,causal", [(1500, 4, 4, 384, False),
                                              (1500, 4, 4, 512, False),
                                              (1024, 8, 2, 384, True),
                                              (1024, 8, 2, 512, True)])
def test_prefill_wide_heads_long_sequences(cuda, S, H, KV, hd, causal):
    """The wide-head B3 bidirectional at S = 1500 (whisper's encoder length)
    and causal at S = 1024 with G = 4, B=2: within 2e-5 of plain, each
    sequence's rows equal its B=1 call's and a repeated call's."""
    g = torch.Generator(device=cuda).manual_seed(S + H + hd)
    q = torch.randn((2, S, H, hd), generator=g, device=cuda)
    k = torch.randn((2, S, KV, hd), generator=g, device=cuda)
    v = torch.randn((2, S, KV, hd), generator=g, device=cuda)
    kw = dict(causal=causal, window=0, prefix_len=0)
    call = lambda *a: PA.prefill_attention(*a, **kw)  # noqa: E731
    before = PA.launches
    out = call(q, k, v)
    assert PA.launches == before + 1
    torch.testing.assert_close(out, PA.prefill_attention_plain(q, k, v, **kw),
                               rtol=0, atol=2e-5)
    assert torch.equal(_same_bytes_alone_and_again(call, (q, k, v), 2), out)


@pytest.mark.parametrize("hd", [640, 1028])
def test_wide_heads_above_one_column_slice(cuda, hd):
    """hd above 512 (two and three 512-column slices, the last one short):
    B2 at cache_len 0, the chunk edges and past W, and B3 causal, windowed,
    with a prefix and bidirectional, within 2e-5 of plain, rows equal to
    B=1 calls."""
    _wide_decode_check(cuda, [0, 1, 31, 33, 300, 309], 300, 8, 2, hd)
    g = torch.Generator(device=cuda).manual_seed(hd)
    for causal, window, prefix in ((True, 0, 0), (True, 24, 0), (True, 0, 19),
                                   (False, 0, 0)):
        q = torch.randn((2, 70, 8, hd), generator=g, device=cuda)
        k = torch.randn((2, 70, 2, hd), generator=g, device=cuda)
        v = torch.randn((2, 70, 2, hd), generator=g, device=cuda)
        kw = dict(causal=causal, window=window, prefix_len=prefix)
        call = lambda *a: PA.prefill_attention(*a, **kw)  # noqa: E731
        out = _same_bytes_alone_and_again(call, (q, k, v), 2)
        torch.testing.assert_close(out, PA.prefill_attention_plain(q, k, v, **kw),
                                   rtol=0, atol=2e-5, msg=str(kw))


def test_kernel_backend_on_cuda_matches_numpy(cuda):
    rng = np.random.default_rng(9)
    emb = _tie_heavy(rng, 2100, 32)
    kern = TorchKernelBackend(emb, device=cuda)
    assert kern._kb.is_cuda
    for B, k in ((1, 1), (12, 20), (5, 256)):
        qs = _grid(rng, B, 32)
        fi, fs = FlatBackend(emb).search(qs, k)
        ki, ks = kern.search(qs, k)
        assert np.array_equal(fi, ki) and np.array_equal(fs, ks)


def _ragged_cand(rng, B, C, N):
    """Id-sorted rows of ragged width, -1 pads; row 0 repeats an id, row 2 is
    all pad."""
    cand = np.full((B, C), -1, np.int32)
    for b in range(B):
        if b == 2:
            continue
        w = int(rng.integers(1, min(C, N)))
        cand[b, :w] = np.sort(rng.choice(N, size=w, replace=False))
    cand[0, 1] = cand[0, 0]
    return cand


@pytest.mark.parametrize("d", [64, 768])
@pytest.mark.parametrize("k", [1, 20, 256])
def test_gathered_kernels_match_plain(cuda, d, k):
    """B4, B5, B7, B8 against their plain versions byte for byte on a
    tie-heavy grid KB; B4 == B5, B7 == B8; B=1 rows == B=12 rows."""
    rng = np.random.default_rng(d + k)
    N, C = 3001, 1300
    emb = _tie_heavy(rng, N, d)
    codes, scales = (torch.from_numpy(a).to(cuda) for a in quantize_kb(emb))
    kb = torch.from_numpy(emb).to(cuda)
    q = torch.from_numpy(_grid(rng, 12, d)).to(cuda)
    cand = torch.from_numpy(_ragged_cand(rng, 12, C, N)).to(cuda)
    safe = cand.clamp(min=0).long()
    args = {"fused_gathered_topk": (q, kb, cand),
            "gathered_topk": (q, kb[safe].contiguous(), cand),
            "quant_fused_gathered_topk": (q, codes, scales, cand),
            "quant_gathered_topk": (q, codes[safe].contiguous(),
                                    scales[safe].contiguous(), cand)}
    out = {}
    for name, a in args.items():
        before = GT.launches[name]
        out[name] = getattr(GT, name)(*a, k)
        assert GT.launches[name] == before + 1
        plain = getattr(GT, f"{name}_plain")(*a, k)
        assert torch.equal(out[name][0], plain[0]) and torch.equal(out[name][1], plain[1]), name
        # query 0 alone: q and cand (and a slab) cut to its row
        first = tuple(t[:1].contiguous() if t.shape[0] == 12 else t for t in a)
        one = getattr(GT, name)(*first, k)
        assert torch.equal(one[0][0], out[name][0][0]) and torch.equal(one[1][0], out[name][1][0])
    for x, y in (("fused_gathered_topk", "gathered_topk"),
                 ("quant_fused_gathered_topk", "quant_gathered_topk")):
        assert torch.equal(out[x][0], out[y][0]) and torch.equal(out[x][1], out[y][1])
    assert (out["fused_gathered_topk"][1][2] == -1).all()
    # ids past the KB's rows are not read: the kernel and the plain version
    # both score them NEG and keep their ids
    cand[1, :3] = torch.tensor([N, N + 5, 10**9], dtype=torch.int32, device=cuda)
    for name in ("fused_gathered_topk", "quant_fused_gathered_topk"):
        a = args[name]
        got, want = getattr(GT, name)(*a, k), getattr(GT, f"{name}_plain")(*a, k)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), name


@pytest.mark.parametrize("N", [3001, 100])
@pytest.mark.parametrize("B,k", [(1, 1), (12, 20), (64, 20), (64, 256)])
def test_quant_topk_kernel_matches_plain(cuda, N, B, k):
    rng = np.random.default_rng(B + k + N)
    k = min(k, N)
    codes, scales = (torch.from_numpy(a).to(cuda)
                     for a in quantize_kb(_tie_heavy(rng, N, 64)))
    q = torch.from_numpy(_grid(rng, B, 64)).to(cuda)
    before = QT.launches
    s_k, i_k = QT.quant_dense_topk(q, codes, scales, k)
    s_p, i_p = QT.quant_dense_topk_plain(q, codes, scales, k)
    assert QT.launches == before + 1
    assert torch.equal(s_k, s_p) and torch.equal(i_k, i_p)


def test_gathered_and_int8_backends_on_cuda_match_numpy(cuda):
    rng = np.random.default_rng(10)
    emb = _tie_heavy(rng, 2100, 32)
    flat, kern = FlatBackend(emb), TorchKernelBackend(emb, device=cuda)
    qflat, qkern = QuantizedFlatBackend(emb), TorchQuantizedKernelBackend(emb, device=cuda)
    assert qkern._codes.is_cuda
    for B, k in ((1, 1), (12, 20), (5, 256)):
        qs = _grid(rng, B, 32)
        cand = _ragged_cand(rng, max(B, 3), 700, 2100)[:B].astype(np.int64)
        for want, got in ((flat.search_gathered(qs, cand, k), kern.search_gathered(qs, cand, k)),
                          (qflat.search(qs, k), qkern.search(qs, k)),
                          (qflat.search_gathered(qs, cand, k),
                           qkern.search_gathered(qs, cand, k))):
            assert np.array_equal(want[0], got[0]) and np.array_equal(want[1], got[1])
    assert kern.gathered_scratch_bytes(12, 700, 20) == \
        DT.scan_scratch(12, 700, 20, DT.sm_count(kern.device), per_query=True)[1]


def test_kernel_wrappers_refuse_what_they_do_not_take(cuda):
    """What the kernels still refuse: non-contiguous input, a wrong dtype,
    k and v whose head width is not q's. Any d and any k <= N (<= C, or
    more, for the gathered scans) are taken, and any head width: hd 264
    launches the wide-head kernels (ROADMAP fault C3)."""
    with pytest.raises(ValueError, match="contiguous"):
        DT.dense_topk(torch.zeros((8, 2), device=cuda).T,
                      torch.zeros((300, 8), device=cuda), 1)
    with pytest.raises(ValueError, match="contiguous"):
        QT.quant_dense_topk(torch.zeros((1, 16), device=cuda),
                            torch.zeros((16, 300), dtype=torch.int8, device=cuda).T,
                            torch.ones(300, device=cuda), 1)
    with pytest.raises(TypeError, match="float32"):
        DT.dense_topk(torch.zeros((1, 8), dtype=torch.float64, device=cuda),
                      torch.zeros((300, 8), device=cuda), 1)
    q = torch.zeros((1, 2, 264), device=cuda)
    kc = torch.zeros((1, 8, 2, 264), device=cuda)
    with pytest.raises(ValueError, match="shapes"):
        DA.decode_attention(q, kc[..., :260].contiguous(), kc[..., :260].contiguous(),
                            torch.ones(1, dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError, match="shapes"):
        PA.prefill_attention(q[:, None].contiguous(), kc[:, :1, :, :260].contiguous(),
                             kc[:, :1, :, :260].contiguous())
    before = (DA.launches, PA.launches)
    DA.decode_attention(q, kc, kc, torch.ones(1, dtype=torch.int32, device=cuda))
    PA.prefill_attention(q[:, None].contiguous(), kc[:, :1].contiguous(),
                         kc[:, :1].contiguous())
    assert (DA.launches, PA.launches) == (before[0] + 1, before[1] + 1)
    cand = torch.zeros((1, 4), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="int8"):
        GT.quant_fused_gathered_topk(torch.zeros((1, 8), device=cuda),
                                     torch.zeros((30, 8), device=cuda),
                                     torch.ones(30, device=cuda), cand, 1)
    with pytest.raises(TypeError, match="int32"):
        GT.fused_gathered_topk(torch.zeros((1, 8), device=cuda),
                               torch.zeros((30, 8), device=cuda), cand.long(), 1)
    with pytest.raises(ValueError, match="contiguous"):
        GT.gathered_topk(torch.zeros((1, 8), device=cuda),
                         torch.zeros((8, 4, 1), device=cuda).permute(2, 1, 0), cand, 1)


def _counts():
    return (DT.launches, QT.launches, dict(GT.launches))


@pytest.mark.parametrize("d", [6, 50])
def test_kernel_backends_serve_any_d_and_k_on_cuda(cuda, d):
    """C1: both CUDA backends at d in {6, 50}, B=3, over a 3000-row KB, at
    k = 20, 300 and N, equal FlatBackend / QuantizedFlatBackend byte for
    byte (full scans and gathered scans), and every call launched its
    kernel (no plain version ran on the card)."""
    rng = np.random.default_rng(d)
    N = 3000
    emb = _tie_heavy(rng, N, d)
    flat, kern = FlatBackend(emb), TorchKernelBackend(emb, device=cuda)
    qflat, qkern = QuantizedFlatBackend(emb), TorchQuantizedKernelBackend(emb, device=cuda)
    assert kern._kb.shape[1] % 4 == 0 and qkern._codes.shape[1] % 16 == 0
    qs = _grid(rng, 3, d)
    cand = _ragged_cand(rng, 3, 700, N).astype(np.int64)
    for k in (20, 300, N):
        for want, call, kernel in (
                (flat.search(qs, k), lambda: kern.search(qs, k), "dense"),
                (qflat.search(qs, k), lambda: qkern.search(qs, k), "quant"),
                (flat.search_gathered(qs, cand, k), lambda: kern.search_gathered(qs, cand, k),
                 "fused_gathered_topk"),
                (qflat.search_gathered(qs, cand, k), lambda: qkern.search_gathered(qs, cand, k),
                 "quant_fused_gathered_topk")):
            before = _counts()
            got = call()
            after = _counts()
            launched = {"dense": after[0] - before[0], "quant": after[1] - before[1]}
            launched.update({n: after[2][n] - before[2][n] for n in GT.launches})
            assert launched[kernel] == 1, (kernel, k)
            assert np.array_equal(want[0], got[0]) and np.array_equal(want[1], got[1]), (kernel, k)


@pytest.mark.parametrize("N,k", [(3001, 257), (3001, 300), (3001, 3001), (40_000, 40_000)])
@pytest.mark.parametrize("B", [1, 5, 20])
def test_scan_kernels_take_k_past_256(cuda, N, k, B):
    """B1 and B6 above the lists' k: the key pass and the select pass equal
    the plain versions byte for byte on a tie-heavy grid KB (k = N = 40,000
    sorts in device memory), at d = 50 (padded) and 64."""
    rng = np.random.default_rng(N + k + B)
    for d in (50, 64):
        emb = _tie_heavy(rng, N, d)
        kb = torch.from_numpy(emb).to(cuda)
        codes, scales = (torch.from_numpy(a).to(cuda) for a in quantize_kb(emb))
        q = torch.from_numpy(_grid(rng, B, d)).to(cuda)
        before = (DT.launches, QT.launches)
        got = DT.dense_topk(q, kb, k)
        want = DT.dense_topk_plain(q, kb, k)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        got = QT.quant_dense_topk(q, codes, scales, k)
        want = QT.quant_dense_topk_plain(q, codes, scales, k)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert (DT.launches, QT.launches) == (before[0] + 1, before[1] + 1)


def _gathered_args(q, kb, codes, scales, cand):
    safe = cand.clamp(min=0).long()
    return {"fused_gathered_topk": (q, kb, cand),
            "gathered_topk": (q, kb[safe].contiguous(), cand),
            "quant_fused_gathered_topk": (q, codes, scales, cand),
            "quant_gathered_topk": (q, codes[safe].contiguous(),
                                    scales[safe].contiguous(), cand)}


@pytest.mark.parametrize("d,C,k", [(50, 1300, 20), (50, 1300, 300), (64, 1300, 1300),
                                   (50, 1300, 1500), (6, 20_000, 20_000)])
def test_gathered_kernels_take_any_d_and_k(cuda, d, C, k):
    """Every gathered wrapper at d = 50 or 6 (padded), at k > 256 (the key
    pass and the select pass; k = C = 20,000 sorts in device memory) and at
    k > C (pads) equals its plain version byte for byte on a tie-heavy grid
    KB, ids past N included."""
    rng = np.random.default_rng(d + C + k)
    N = 3001
    emb = _tie_heavy(rng, N, d)
    codes, scales = (torch.from_numpy(a).to(cuda) for a in quantize_kb(emb))
    kb = torch.from_numpy(emb).to(cuda)
    q = torch.from_numpy(_grid(rng, 4, d)).to(cuda)
    cand = torch.from_numpy(_ragged_cand(rng, 4, C, N)).to(cuda)
    past_n = cand.clone()                  # for the fused scans only: the slabs
    past_n[1, :3] = torch.tensor([N, N + 5, 10**9], dtype=torch.int32, device=cuda)
    runs = list(_gathered_args(q, kb, codes, scales, cand).items()) + [
        ("fused_gathered_topk", (q, kb, past_n)),
        ("quant_fused_gathered_topk", (q, codes, scales, past_n))]
    for name, a in runs:
        before = GT.launches[name]
        got = getattr(GT, name)(*a, k)
        want = getattr(GT, f"{name}_plain")(*a, k)
        assert GT.launches[name] == before + 1
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), name


@pytest.mark.parametrize("k", [1, 20, 300])
def test_gathered_rows_do_not_depend_on_the_batch(cuda, k):
    """On unit-normal data (where the summation order shows) a query's row
    from the B=12 call equals its row from a B=1 call byte for byte, for
    each of B4, B5, B7, B8, and the scores are within 1e-5 of the plain
    versions'."""
    g = torch.Generator(device=cuda).manual_seed(k)
    N, C, d = 20_000, 4000, 768
    kb = torch.randn((N, d), generator=g, device=cuda)
    kb /= kb.norm(dim=1, keepdim=True)
    codes, scales = (torch.from_numpy(a).to(cuda) for a in quantize_kb(kb.cpu().numpy()))
    q = torch.randn((12, d), generator=g, device=cuda)
    q /= q.norm(dim=1, keepdim=True)
    rng = np.random.default_rng(k)
    cand = torch.from_numpy(_ragged_cand(rng, 12, C, N)).to(cuda)
    for name, a in _gathered_args(q, kb, codes, scales, cand).items():
        s12, i12 = getattr(GT, name)(*a, k)
        torch.testing.assert_close(s12, getattr(GT, f"{name}_plain")(*a, k)[0], rtol=0,
                                   atol=1e-5)
        for b in range(12):
            one = tuple(t[b:b + 1].contiguous() if t.shape[0] == 12 else t for t in a)
            s1, i1 = getattr(GT, name)(*one, k)
            assert torch.equal(s1[0], s12[b]) and torch.equal(i1[0], i12[b]), (name, b)


def test_kernel_launches_capture_in_a_cuda_graph(cuda):
    """A wrapper's launch makes no CUDA runtime call besides the launch (the
    shared-memory attribute is set once per kernel), so the calls capture in
    a CUDA graph in global mode and replay to the eager results."""
    rng = np.random.default_rng(12)
    emb = _tie_heavy(rng, 3001, 64)
    kb = torch.from_numpy(emb).to(cuda)
    codes, scales = (torch.from_numpy(a).to(cuda) for a in quantize_kb(emb))
    q = torch.from_numpy(_grid(rng, 12, 64)).to(cuda)
    cand = torch.from_numpy(_ragged_cand(rng, 12, 700, 3001)).to(cuda)
    g = torch.Generator(device=cuda).manual_seed(5)
    pq, pk, pv = (torch.randn((1, 160, 16, 64), generator=g, device=cuda) for _ in range(3))
    dq = torch.randn((4, 16, 64), generator=g, device=cuda)
    kc, vc = (torch.randn((4, 512, 16, 64), generator=g, device=cuda) for _ in range(2))
    lens = torch.tensor([1, 97, 300, 512], dtype=torch.int32, device=cuda)
    calls = [lambda: DT.dense_topk(q, kb, 20), lambda: QT.quant_dense_topk(q, codes, scales, 20),
             lambda: GT.fused_gathered_topk(q, kb, cand, 20),
             lambda: (PA.prefill_attention(pq, pk, pv),),
             lambda: (DA.decode_attention(dq, kc, vc, lens),)]
    for fn in calls:
        want = fn()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            got = fn()
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, want))


# ---------------------------------------------------------------------------------
# KNN-LM serving hooks of the batched engine on the card
# ---------------------------------------------------------------------------------
def _knn_stack(cuda):
    from repro_torch.configs import RaLMConfig
    from repro_torch.launch.serve import build_stack
    return build_stack("edr", n_docs=300, workload="knnlm", knn_entries=6000,
                       backend="kernel", device=cuda,
                       rcfg=RaLMConfig(max_new_tokens=16, speculation_stride=3))


def test_batched_peek_logits_rows_match_the_single_engine(cuda):
    """Row b of a B=4 step's logits against the same context decoded at B=1:
    cuBLAS may pick other GEMMs at M=4 and M=1, so the rows may differ in
    the last bits (the largest difference is printed); the argmax agrees."""
    from repro_torch.serving.batched import BatchedServeEngine
    from repro_torch.serving.engine import ServeEngine
    st = _knn_stack(cuda)
    prompts = [st.stream[i * 97:i * 97 + 48].tolist() for i in range(4)]
    beng = BatchedServeEngine(st.model, st.params, 4, cache_window=64)
    singles = [ServeEngine(st.model, st.params, cache_window=64) for _ in range(4)]
    for b, p in enumerate(prompts):
        beng.start(b, p)
        singles[b].start(p)
    worst = 0.0
    rng = np.random.default_rng(0)
    for _ in range(24):                           # past the 64-entry ring
        toks = rng.integers(2, st.cfg.vocab_size, 4).tolist()
        for b in range(4):
            one, row = singles[b].peek_logits(), beng.peek_logits(b)
            assert one.shape == row.shape == (st.cfg.vocab_size,)
            worst = max(worst, float(np.abs(one - row).max()))
            assert int(np.argmax(one)) == int(np.argmax(row))
            singles[b].advance(toks[b])
        beng.advance(range(4), toks)
    print(f"max |logit difference| B=4 row vs B=1: {worst:.3e}")


def test_batched_advance_keeps_other_rows_and_snapshots(cuda):
    """``advance`` over two of four slots leaves the other two slots' logits
    and positions unchanged, and every snapshot taken before it still
    restores its slot to the logits it had."""
    from repro_torch.serving.batched import BatchedServeEngine
    st = _knn_stack(cuda)
    beng = BatchedServeEngine(st.model, st.params, 4, cache_window=64)
    for b in range(4):
        beng.start(b, st.stream[b * 97:b * 97 + 40].tolist())
    snaps = {b: beng.snapshot(b) for b in range(4)}
    before = {b: beng.peek_logits(b).copy() for b in range(4)}
    pos0 = beng._pos.clone()
    kept = [t.clone() for t in beng._state[0].values()]
    for _ in range(3):
        beng.advance([0, 2], [5, 6])
    assert torch.equal(beng._pos[[1, 3]], pos0[[1, 3]])
    assert torch.equal(beng._pos[[0, 2]], pos0[[0, 2]] + 3)
    for b in (1, 3):
        assert np.array_equal(beng.peek_logits(b), before[b])
    for b in (0, 2):
        assert not np.array_equal(beng.peek_logits(b), before[b])
        assert beng.tokens[b][-3:] == [5 + b // 2] * 3
    # the snapshot's bundle was never written into
    assert all(torch.equal(a, b) for a, b in zip(kept, snaps[0][2][0][0].values()))
    for b in (0, 2):
        beng.restore(b, snaps[b])
        assert np.array_equal(beng.peek_logits(b), before[b])


def test_knnlm_fleet_on_cuda_token_matches_knnlmseq(cuda):
    """A reduced KNN-LM stack on the card: the 3-slot fleet (sync and async)
    and the continuous server give KNNLMSeq's tokens through the same kernel
    backend, one merged B1 scan per round; B1, B2 and B3 are launched."""
    import dataclasses
    from repro_torch.launch.serve import make_server
    from repro_torch.serving.continuous import as_requests
    st = _knn_stack(cuda)
    prompts = [st.stream[i * 97:i * 97 + 48].tolist() for i in range(3)]
    c0 = (DT.launches, DA.launches, PA.launches)
    want = [make_server(st, scheduler="seq").serve(p).tokens for p in prompts]
    assert all(len(t) == 16 for t in want)
    assert DT.launches > c0[0] and DA.launches > c0[1] and PA.launches > c0[2]
    for sched, rounds in (("fixed", False), ("fixed", True), ("continuous", False)):
        s2 = dataclasses.replace(st, engine=None, rcfg=dataclasses.replace(
            st.rcfg, async_verification=rounds, async_gate_ratio=0.0))
        with make_server(s2, scheduler=sched, n_slots=3) as srv:
            calls = DT.launches
            fr = srv.serve(as_requests(prompts) if sched == "continuous" else prompts)
        assert [r.tokens for r in fr.results] == want, (sched, rounds)
        assert DT.launches - calls == fr.kb_calls
        assert fr.kb_calls == fr.rounds + (fr.seed_calls if sched == "continuous" else 1)
    # the decode steps replayed their CUDA graphs: KNNLMSeq's (B = 1) and the fleets' (B = 3)
    replays = {key[0]: g.replays for key, g in st.model._graphs.items()}
    assert replays.get(1, 0) > 0 and replays.get(3, 0) > 0, replays


# ---------------------------------------------------------------------------------
# the decode step replayed from a CUDA graph (models.model.DecodeGraph)
# ---------------------------------------------------------------------------------
GRAPH_ARCHS = {"dense": "qwen3-4b", "moe": "qwen2-moe-a2.7b", "ssm": "xlstm-350m",
               "hybrid": "jamba-v0.1-52b", "vlm": "paligemma-3b", "audio": "whisper-base"}


def _graphed_vs_eager(cuda, arch, B, pos_of, steps=20, W=64):
    """``steps`` decode steps of a reduced ``arch`` from a prefilled W = 64
    ring, eager (grad on) and graphed (grad off) side by side from the same
    state, tokens and positions (``pos_of(i)``). Where the family engages,
    every replay's logits and state equal the eager step's byte for byte,
    launch B2 once a layer, and leave the state they were given as it was;
    elsewhere no graph is made. -> the graph, or None."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import model as MM
    from repro_torch.tree import tree_leaves
    cfg = reduced(get_config(arch), layers=3, d_model=256)
    model = MM.build_model(cfg)
    g = torch.Generator(device=cuda).manual_seed(1)
    params = model.init(g)
    toks = torch.randint(2, cfg.vocab_size, (B, 60), generator=g, device=cuda)
    extra = None
    if cfg.family == "audio":
        extra = {"frames": torch.randn((B, cfg.encoder_frames, cfg.d_model), generator=g,
                                       device=cuda)}
    tok = toks[:, -1]
    with torch.no_grad():
        _, state, _ = model.prefill(params, toks, extra=extra, window_cache=W)
        model.decode_step(params, state, tok, pos_of(0))        # eager: captures the graph
    graph = model.decode_graph(params, state)
    if cfg.family not in MM.GRAPH_FAMILIES:
        assert graph is None and not model._graphs
        return None
    n_attn = cfg.layer_kinds().count("attn")
    eager = graphed = state
    for i in range(steps):
        with torch.enable_grad():
            e_logits, eager = model.decode_step(params, eager, tok, pos_of(i))
        given = graphed
        kept = [t.clone() for t in tree_leaves(given)]
        n0 = DA.launches
        with torch.no_grad():
            g_logits, graphed = model.decode_step(params, given, tok, pos_of(i))
        assert DA.launches - n0 == n_attn
        assert all(torch.equal(a, b) for a, b in zip(kept, tree_leaves(given)))
        assert torch.equal(g_logits, e_logits), (arch, i)
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(graphed), tree_leaves(eager)))
        tok = e_logits.argmax(-1)
    assert (graph.replays, graph.copies) == (steps, 1)      # the prefill's state, then none
    return graph


@pytest.mark.parametrize("family", sorted(GRAPH_ARCHS))
def test_graphed_decode_step_is_bit_equal_to_eager(cuda, family):
    """Per-slot positions past the ring (W = 64), 20 steps: see
    ``_graphed_vs_eager``; the dense family must engage."""
    base = torch.tensor([60, 75, 130, 64], dtype=torch.int32, device=cuda)
    graph = _graphed_vs_eager(cuda, GRAPH_ARCHS[family], 4, lambda i: base + i)
    assert graph is not None or family != "dense"


def test_graphed_decode_step_at_a_scalar_position(cuda):
    """One slot at an int position past the ring (the single engine's
    call): the graph takes the position as a (1,) tensor, bit-equal."""
    assert _graphed_vs_eager(cuda, GRAPH_ARCHS["dense"], 1, lambda i: 70 + i) is not None


def test_graphed_engine_restores_a_slot_as_the_eager_engine(cuda, monkeypatch):
    """A 4-slot engine warmed (the graph captured), four prefills, three
    ``advance`` steps over every slot, one slot restored to its snapshot,
    then a 6-step ``gen``: the tokens and logits of the eager engine, and
    the dispatch spans show one copy-in after the prefills, one after the
    restore and none in the straight steps."""
    from repro_torch import trace
    from repro_torch.models import model as MM
    from repro_torch.serving.batched import BatchedServeEngine
    st = _knn_stack(cuda)
    prompts = [st.stream[i * 97:i * 97 + 40].tolist() for i in range(4)]

    def serve():
        eng = BatchedServeEngine(st.model, st.params, 4, cache_window=64)
        eng.warm([40])
        for b, p in enumerate(prompts):
            eng.start(b, p)
        snaps = {b: eng.snapshot(b) for b in range(4)}
        trace.clear()
        with trace.recording():
            for step in range(3):
                eng.advance(range(4), [5 + step, 6, 7, 8])
            eng.restore(1, snaps[1])
            eng.gen(range(4), [6] * 4)
        spans = [(s.attrs["graph"], s.attrs["copied"]) for s in trace.spans()
                 if s.name == "engine.dispatch"]
        trace.clear()
        return [list(t) for t in eng.tokens], [eng.peek_logits(b) for b in range(4)], spans

    with monkeypatch.context() as m:
        m.setattr(MM, "GRAPH_FAMILIES", ())
        e_tokens, e_logits, e_spans = serve()
    assert not st.model._graphs and e_spans == [(0, 0)] * 9
    g_tokens, g_logits, g_spans = serve()
    assert g_tokens == e_tokens
    assert all(np.array_equal(a, b) for a, b in zip(g_logits, e_logits))
    assert g_spans == [(1, 1), (1, 0), (1, 0), (1, 1)] + [(1, 0)] * 5


# ---------------------------------------------------------------------------------
# the MoE, SSM, hybrid and VLM families on the card
# ---------------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "qwen2-moe-a2.7b", "xlstm-350m",
                                  "paligemma-3b"])
def test_new_families_fleet_on_cuda_matches_ralmseq(cuda, arch):
    """A reduced stack of each newly served family on the card (Jamba:
    Mamba, attention and MoE layers in one model): the 3-slot psa fleet
    gives RaLMSeq's tokens with one merged B1 call per round; B1 is
    launched, and B2 and B3 wherever the model has attention."""
    import dataclasses
    from repro_torch.configs import RaLMConfig
    from repro_torch.launch.serve import build_stack, make_server, variant_config
    from repro_torch.training.data import make_queries
    st = build_stack("edr", n_docs=600, arch=arch, backend="kernel", device=cuda,
                     rcfg=RaLMConfig(max_new_tokens=16))
    prompts = [(q * 12)[:40] for q in make_queries(st.docs, 3)]
    c0 = (DT.launches, DA.launches, PA.launches)
    want = [make_server(st, scheduler="seq").serve(p).tokens for p in prompts]
    assert all(len(t) == 16 for t in want)
    attn = "attn" in st.cfg.layer_kinds()
    assert DT.launches > c0[0]
    assert (DA.launches > c0[1]) == attn and (PA.launches > c0[2]) == attn
    fleet_st = dataclasses.replace(st, engine=None, rcfg=variant_config("psa", st.rcfg))
    with make_server(fleet_st, scheduler="fixed", n_slots=3) as fleet:
        calls = DT.launches
        fr = fleet.serve(prompts)
    assert [r.tokens for r in fr.results] == want
    assert DT.launches - calls == fr.kb_calls == fr.rounds + 1


# ---------------------------------------------------------------------------------
# the sharded backends and the audio family on the card
# ---------------------------------------------------------------------------------
@pytest.mark.parametrize("N,S", [(9, 4), (3001, 3), (3001, 2), (3001, 4), (70_001, 4)])
def test_sharded_backends_on_cuda_equal_the_kernel_backends(cuda, N, S):
    """``sharded`` == ``kernel`` and ``int8-sharded`` == ``int8-kernel`` byte
    for byte on a tie-heavy grid KB, search and search_gathered, with an
    empty last shard (N = 9, S = 4) and short ones; a search launches B1
    (B6) once per nonempty shard, a gathered search B4 (B7) once per shard
    that owns a candidate."""
    from repro_torch.retrieval.backends import QuantizedShardedBackend, ShardedBackend
    from repro_torch.retrieval.sharded import shard_bounds
    rng = np.random.default_rng(N + S)
    emb = _tie_heavy(rng, N, 40)
    nonempty = sum(hi > lo for lo, hi in shard_bounds(N, S))
    pairs = ((TorchKernelBackend(emb, device=cuda), ShardedBackend(emb, S, device=cuda),
              lambda: DT.launches, lambda: GT.launches["fused_gathered_topk"]),
             (TorchQuantizedKernelBackend(emb, device=cuda),
              QuantizedShardedBackend(emb, S, device=cuda),
              lambda: QT.launches, lambda: GT.launches["quant_fused_gathered_topk"]))
    for whole, sharded, scans, gathers in pairs:
        assert sharded.n_shards == S and all(r.is_cuda for r in sharded._rows)
        for B in (1, 12):
            qs = _grid(rng, B, 40)
            cand = _ragged_cand(rng, max(B, 3), min(700, N), N)[:B].astype(np.int64)
            for k in (1, 20, min(300, N)):
                before = scans()
                got = sharded.search(qs, k)
                assert scans() - before == nonempty
                want = whole.search(qs, k)
                assert np.array_equal(want[0], got[0]) and np.array_equal(want[1], got[1])
                before = gathers()
                got = sharded.search_gathered(qs, cand, k)
                owners = sum(bool(((cand >= lo) & (cand < hi)).any())
                             for lo, hi in shard_bounds(N, S))
                assert gathers() - before == owners
                want = whole.search_gathered(qs, cand, k)
                assert np.array_equal(want[0], got[0]) and np.array_equal(want[1], got[1])


def test_whisper_fleet_on_cuda_matches_ralmseq(cuda):
    """A reduced whisper-base stack on the card, its frames handed to every
    prefill by the engines: the 3-slot psa fleet gives RaLMSeq's tokens with
    one merged B1 call per round, and B1, B2 and B3 (the decoder's, and the
    encoder's bidirectional) are launched."""
    import dataclasses
    from repro_torch.configs import RaLMConfig
    from repro_torch.launch.serve import build_stack, make_server, variant_config
    from repro_torch.serving.batched import BatchedServeEngine
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.training.data import make_queries
    st = build_stack("edr", n_docs=600, arch="whisper-base", backend="kernel", device=cuda,
                     rcfg=RaLMConfig(max_new_tokens=16))
    g = torch.Generator(device=cuda).manual_seed(0)
    extra = {"frames": torch.randn((1, st.cfg.encoder_frames, st.cfg.d_model),
                                   generator=g, device=cuda)}
    prompts = [(q * 12)[:40] for q in make_queries(st.docs, 3)]
    c0 = (DT.launches, DA.launches, PA.launches)
    eng = ServeEngine(st.model, st.params, cache_window=512, extra=extra)
    want = [make_server(st, scheduler="seq", engine=eng).serve(p).tokens for p in prompts]
    assert all(len(t) == 16 for t in want)
    assert DT.launches > c0[0] and DA.launches > c0[1] and PA.launches > c0[2]
    fleet_st = dataclasses.replace(st, engine=None, rcfg=variant_config("psa", st.rcfg))
    beng = BatchedServeEngine(st.model, st.params, 3, cache_window=512, extra=extra)
    with make_server(fleet_st, scheduler="fixed", n_slots=3, engine=beng) as fleet:
        calls = DT.launches
        fr = fleet.serve(prompts)
    assert [r.tokens for r in fr.results] == want
    assert DT.launches - calls == fr.kb_calls == fr.rounds + 1


# ---------------------------------------------------------------------------------
# training on the card
# ---------------------------------------------------------------------------------
def _train_inputs(arch, device, seed=0):
    """A reduced config's parameters (drawn on the CPU from ``seed``) and one
    SyntheticLM batch with zero frames or patches, on ``device``."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.train import add_extra
    from repro_torch.models.model import Model
    from repro_torch.training.data import SyntheticLM
    from repro_torch.tree import tree_map
    from repro_torch.training.trainer import to_device
    cfg = reduced(get_config(arch))
    params = Model(cfg).init(torch.Generator().manual_seed(seed))
    batch = add_extra(cfg, SyntheticLM(cfg.vocab_size, 32, 4).batch(1))
    return (cfg, tree_map(lambda t: t.to(device), params), to_device(batch, device))


@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen2-moe-a2.7b", "xlstm-350m",
                                  "paligemma-3b", "whisper-base"])
def test_train_step_on_cuda_matches_cpu(cuda, arch):
    """One train step (the differentiable route, the capacity MoE) from the
    same parameters and batch on the card and on the CPU: loss, aux and grad
    norm within rtol = atol = 1e-4, the updated parameters within 2e-5 where
    the step's first moment is at least 1e-6 in magnitude (below it Adam's
    normalised step turns rounding into up to 2 lr: tests/test_torch_training.py)."""
    from repro_torch.models.model import Model
    from repro_torch.training.optimizer import AdamWConfig, init_adamw
    from repro_torch.tree import tree_leaves
    from repro_torch.training.trainer import make_train_step
    results = []
    for dev in (torch.device("cpu"), cuda):
        cfg, params, batch = _train_inputs(arch, dev)
        opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
        p, st, m = make_train_step(Model(cfg), opt)(params, init_adamw(params), batch)
        results.append((m, tree_leaves(p), tree_leaves(st.mu)))
    (m0, p0, mu0), (m1, p1, mu1) = results
    for k in ("loss", "aux", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m1[k]), float(m0[k]), rtol=1e-4, atol=1e-4)
    lr = float(m0["lr"])
    for a, b, mu in zip(p0, p1, mu0):
        err = (b.cpu() - a).abs()
        noisy = mu.abs() < 1e-6
        assert float(torch.where(noisy, 0.0, err).max()) <= 2e-5
        assert float(err.max()) <= 2 * lr


def test_eval_loss_through_b3_matches_the_differentiable_route(cuda):
    """The eval step (B3 on the card, under no_grad) against the training
    loss on the differentiable route, within 1e-5 relative; B3 launched."""
    from repro_torch.models.model import Model
    from repro_torch.training.trainer import make_eval_step, make_loss_fn
    cfg, params, batch = _train_inputs("paligemma-3b", cuda)
    model = Model(cfg)
    before = PA.launches
    got = make_eval_step(model)(params, batch)
    assert PA.launches - before == cfg.num_layers
    with torch.no_grad():
        want, parts = make_loss_fn(model)(params, batch)
    np.testing.assert_allclose(float(got["total"]), float(want), rtol=1e-5, atol=0)
    np.testing.assert_allclose(float(got["loss"]), float(parts["loss"]), rtol=1e-5, atol=0)


def test_attention_kernels_refuse_inputs_that_require_grad(cuda):
    """B3 and B2 have no backward: on CUDA inputs that require grad, under
    grad mode, both wrappers raise before launching; under no_grad they run."""
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn((1, 16, 4, 64), generator=g, device=cuda).requires_grad_()
    k = torch.randn((1, 16, 4, 64), generator=g, device=cuda)
    lens = torch.full((1,), 16, dtype=torch.int32, device=cuda)
    before = (PA.launches, DA.launches)
    with pytest.raises(RuntimeError, match="no backward"):
        PA.prefill_attention(q, k, k)
    with pytest.raises(RuntimeError, match="no backward"):
        DA.decode_attention(q[:, 0], k, k, lens)
    assert (PA.launches, DA.launches) == before
    with torch.no_grad():
        PA.prefill_attention(q, k, k)
        DA.decode_attention(q[:, 0].contiguous(), k, k, lens)
    assert (PA.launches, DA.launches) == (before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("B,H,KV,lens", [(1, 32, 8, (16384,)), (2, 32, 8, (16384, 9000)),
                                         (1, 8, 1, (16384,)), (2, 16, 16, (1, 16384))])
def test_decode_attention_at_the_long_context_window(cuda, B, H, KV, lens):
    """B2 at long_500k's ring window W = 16,384 (256 chunks of 64 entries a
    row; llama3.2-1b's 32 / 8 heads at hd 64 first): within 2e-5 of the
    plain version, and its partials scratch grown to what the call needs
    (past MIN_SCRATCH at 32 heads)."""
    g = torch.Generator(device=cuda).manual_seed(5)
    W, hd = 16384, 64
    q = torch.randn((B, H, hd), generator=g, device=cuda)
    kc = torch.randn((B, W, KV, hd), generator=g, device=cuda)
    vc = torch.randn((B, W, KV, hd), generator=g, device=cuda)
    ln = torch.tensor(lens, dtype=torch.int32, device=cuda)
    out = DA.decode_attention(q, kc, vc, ln)
    err = (out - DA.decode_attention_plain(q, kc, vc, ln)).abs().max().item()
    assert err <= 2e-5, err
    need = B * H * (W // DA.CHUNK) * (hd + 2)
    assert DA._scratch[q.device.index][5] >= max(need, DA.MIN_SCRATCH)


def test_stacked_decode_matches_flat_at_the_long_context_window(cuda):
    """decode_step_stacked against decode_step over the same W = 16,384
    state on the card (llama3.2-1b's family at 4 layers, per-slot positions
    past the window): logits within 1e-5, one B2 launch per layer and step
    on each path."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.model import build_model
    cfg = reduced(get_config("llama3.2-1b"), layers=4, d_model=256)
    model = build_model(cfg)
    g = torch.Generator(device=cuda).manual_seed(0)
    params = model.init(g)
    state = model.init_decode_state_stacked(2, 16384, device=cuda)
    for t in (t for st in state["stages"] for t in st.values()):
        t.normal_(generator=g)
    flat = model.unstack_decode_state(state)
    tok = torch.tensor([3, 7], device=cuda)
    pos = torch.tensor([524_287, 524_000], device=cuda)
    with torch.no_grad():
        for i in range(4):
            n0 = DA.launches
            s_logits, state = model.decode_step_stacked(params, state, tok, pos + i)
            n1 = DA.launches
            f_logits, flat = model.decode_step(params, flat, tok, pos + i)
            assert (n1 - n0, DA.launches - n1) == (cfg.num_layers, cfg.num_layers)
            assert (s_logits - f_logits).abs().max().item() <= 1e-5
            tok = f_logits.argmax(-1)


def test_attention_kernels_on_one_device_mesh(cuda):
    """B2 and B3 handed DTensors on the 1 x 1 CUDA mesh launch their kernel
    once each on the local tensors (``local_map``) and give the plain-tensor
    launch's output exactly, placed whole; the fake group is torn down
    after."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, distribute_tensor
    from repro_torch.launch.mesh import make_local_mesh
    g = torch.Generator(device=cuda).manual_seed(0)
    B, S, H, KV, hd, W = 2, 40, 8, 2, 64, 96
    q1 = torch.randn((B, H, hd), generator=g, device=cuda)
    kc, vc = (torch.randn((B, W, KV, hd), generator=g, device=cuda) for _ in range(2))
    lens = torch.tensor([17, W], dtype=torch.int32, device=cuda)
    q, k, v = (torch.randn((B, S, n, hd), generator=g, device=cuda) for n in (H, KV, KV))
    mesh = make_local_mesh(cuda)
    try:
        rep = [Replicate(), Replicate()]
        d = [distribute_tensor(t, mesh, rep) for t in (q1, kc, vc, q, k, v)]
        with torch.no_grad():
            n0, m0 = DA.launches, PA.launches
            out_d = DA.decode_attention(d[0], d[1], d[2], lens)
            out_p = PA.prefill_attention(d[3], d[4], d[5], window=9)
            assert (DA.launches - n0, PA.launches - m0) == (1, 1)
            assert tuple(out_d.placements) == tuple(out_p.placements) == tuple(rep)
            assert torch.equal(out_d.to_local(), DA.decode_attention(q1, kc, vc, lens))
            assert torch.equal(out_p.to_local(), PA.prefill_attention(q, k, v, window=9))
    finally:
        dist.destroy_process_group()
