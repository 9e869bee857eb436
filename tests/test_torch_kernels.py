"""The port's kernel modules held against the JAX Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; here those plain
versions meet the reference's Pallas kernels run in interpret mode (as
tests/test_kernels.py runs them). Inputs come from numpy with a seed and go
to both packages. Tolerances:
  * B1 dense top-k: byte equality of ids and scores on grid-quantized KBs
    (entries in multiples of 1/2, so every dot product is exact in fp32 in any
    summation order, and only the canonical tie order can tell results apart);
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
from repro.kernels.dense_topk import dense_topk_pallas
from repro.kernels.prefill_attention import prefill_attention_pallas
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import dense_topk as DT
from repro_torch.kernels import prefill_attention as PA


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


# ---------------------------------------------------------------------------------
# B2 decode attention
# ---------------------------------------------------------------------------------
@pytest.mark.parametrize("B,H,KV,hd,W", [(3, 4, 4, 32, 64), (2, 8, 2, 16, 130),
                                         (4, 8, 1, 64, 257)])
def test_decode_attention_plain_matches_pallas(B, H, KV, hd, W):
    """GQA groups, per-row cache_len, ring slots past cache_len masked."""
    rng = np.random.default_rng(B * W + H)
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    kc = rng.standard_normal((B, W, KV, hd)).astype(np.float32)
    vc = rng.standard_normal((B, W, KV, hd)).astype(np.float32)
    cl = np.asarray([1, W, W // 3, 7][:B], np.int32)
    ref = decode_attention_pallas(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                                  jnp.asarray(cl), block_w=64, interpret=True)
    out = DA.decode_attention(torch.from_numpy(q), torch.from_numpy(kc),
                              torch.from_numpy(vc), torch.from_numpy(cl))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


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
