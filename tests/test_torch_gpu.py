"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here carries the ``gpu`` marker and skips without a CUDA device.
The file imports no JAX, so it runs on a machine that has only the port's
dependencies (there the JAX conftest cannot load):

    PYTHONPATH=src python3 -m pytest -q --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Tolerances: byte equality for the dense top-k on grid-quantized KBs (every
dot product exact in fp32); 2e-5 absolute for attention (fp32 online softmax
in the kernel against one-shot softmax in the plain version).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import dense_topk as DT
from repro_torch.kernels import prefill_attention as PA
from repro_torch.retrieval.backends import FlatBackend, TorchKernelBackend

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


@pytest.mark.parametrize("B,k", [(1, 1), (12, 20), (64, 256)])
def test_dense_topk_kernel_matches_plain(cuda, B, k):
    rng = np.random.default_rng(B + k)
    kb = torch.from_numpy(_tie_heavy(rng, 3001, 64)).to(cuda)
    q = torch.from_numpy(_grid(rng, B, 64)).to(cuda)
    before = DT.launches
    s_k, i_k = DT.dense_topk(q, kb, k)
    s_p, i_p = DT.dense_topk_plain(q, kb, k)
    assert DT.launches == before + 1
    assert torch.equal(s_k, s_p) and torch.equal(i_k, i_p)


@pytest.mark.parametrize("H,KV,hd", [(16, 16, 64), (16, 4, 64), (8, 2, 128)])
def test_decode_attention_kernel_matches_plain(cuda, H, KV, hd):
    g = torch.Generator(device=cuda).manual_seed(H + KV + hd)
    B, W = 4, 512
    q = torch.randn((B, H, hd), generator=g, device=cuda)
    kc = torch.randn((B, W, KV, hd), generator=g, device=cuda)
    vc = torch.randn((B, W, KV, hd), generator=g, device=cuda)
    cl = torch.tensor([1, 97, 300, 512], dtype=torch.int32, device=cuda)
    before = DA.launches
    out = DA.decode_attention(q, kc, vc, cl)
    assert DA.launches == before + 1
    torch.testing.assert_close(out, DA.decode_attention_plain(q, kc, vc, cl),
                               rtol=0, atol=2e-5)


@pytest.mark.parametrize("S,H,KV,hd,window,prefix", [
    (112, 16, 16, 64, 0, 0), (300, 16, 16, 64, 0, 0), (300, 16, 16, 64, 64, 0),
    (200, 16, 16, 64, 0, 37), (160, 16, 4, 64, 0, 0), (70, 4, 2, 128, 0, 0)])
def test_prefill_attention_kernel_matches_plain(cuda, S, H, KV, hd, window, prefix):
    g = torch.Generator(device=cuda).manual_seed(S + H)
    q = torch.randn((1, S, H, hd), generator=g, device=cuda)
    k = torch.randn((1, S, KV, hd), generator=g, device=cuda)
    v = torch.randn((1, S, KV, hd), generator=g, device=cuda)
    kw = dict(causal=True, window=window, prefix_len=prefix)
    before = PA.launches
    out = PA.prefill_attention(q, k, v, **kw)
    assert PA.launches == before + 1
    torch.testing.assert_close(out, PA.prefill_attention_plain(q, k, v, **kw),
                               rtol=0, atol=2e-5)


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


def test_kernel_wrappers_refuse_what_they_do_not_take(cuda):
    kb = torch.zeros((300, 6), device=cuda)
    with pytest.raises(ValueError, match="d % 4"):
        DT.dense_topk(torch.zeros((1, 6), device=cuda), kb, 1)
    with pytest.raises(ValueError, match="k <= 256"):
        DT.dense_topk(torch.zeros((1, 8), device=cuda),
                      torch.zeros((300, 8), device=cuda), 257)
    with pytest.raises(ValueError, match="contiguous"):
        DT.dense_topk(torch.zeros((8, 2), device=cuda).T,
                      torch.zeros((300, 8), device=cuda), 1)
    q = torch.zeros((1, 2, 32), device=cuda)
    kc = torch.zeros((1, 8, 2, 32), device=cuda)
    with pytest.raises(ValueError, match="hd in"):
        DA.decode_attention(q, kc, kc, torch.ones(1, dtype=torch.int32, device=cuda))
