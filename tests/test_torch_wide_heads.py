"""B2 and B3 above hd 256 (the wide-head kernels of ``csrc/wide_attention.cuh``).

On the CPU the wrappers run their plain versions; here those meet the
reference's Pallas kernels in interpret mode (as tests/test_kernels.py runs
them) at hd 384 and 512, with 12 query heads a KV head, a bidirectional
prefix and no causal mask, to 1e-5 (fp32 online softmax in Pallas against
one-shot softmax in the plain version). The kernel path itself is checked
with the library replaced by a recorder: the scratch each launch is handed
and the launch count. The kernels against their plain versions on the card
are in tests/test_torch_gpu.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import decode_attention_pallas
from repro.kernels.prefill_attention import prefill_attention_pallas
from repro_torch.kernels import _build
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import prefill_attention as PA

# six xdist workers share the host's cores: one torch thread each
torch.set_num_threads(1)


@pytest.fixture
def recorded(monkeypatch):
    """Every C entry point replaced by a recorder of its arguments, the
    kernel path taken for CPU tensors, and an empty per-device scratch."""
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
    monkeypatch.setattr(DA, "_scratch", {})
    monkeypatch.setattr(PA, "_fn", None)
    return seen


@pytest.mark.parametrize("hd", [264, 384, 512])
@pytest.mark.parametrize("W", [9, 300, 4096])
def test_decode_wrapper_hands_the_wide_kernel_its_scratch(recorded, hd, W):
    """Above hd 256 a call hands the kernel a partials scratch of B * H *
    min(ceil(W / 32), 64) * (hd + 2) floats (chunks of 32 entries, longer
    where a slot would pass 64 chunks) and B * KV zeroed tickets, and
    counts one launch."""
    B, H, KV = 2, 24, 2
    q, kc = torch.zeros((B, H, hd)), torch.zeros((B, W, KV, hd))
    before = DA.launches
    out = DA.decode_attention(q, kc, kc, torch.ones(B, dtype=torch.int32))
    assert out.shape == (B, H, hd) and DA.launches == before + 1
    (entry, args), = recorded
    assert entry == "decode_attention_launch" and args[11] == hd
    want = B * H * min(-(-W // 32), 64) * (hd + 2)
    assert DA.partials_size(B, H, W, hd) == want
    tickets, part, t_ptr, p_ptr, n_tickets, n_partials = DA._scratch[None]
    assert (args[5], args[6]) == (p_ptr, t_ptr)
    assert part.numel() == n_partials >= want and tickets.numel() == n_tickets >= B * KV
    assert tickets.dtype == torch.int32 and not tickets.any()


def test_prefill_wrapper_makes_one_wide_launch_a_call(recorded):
    """B3 above hd 256: one launch a call, at the padded hd, no scratch."""
    before = PA.launches
    for hd in (264, 384, 512):
        qs, ks = torch.zeros((1, 5, 4, hd)), torch.zeros((1, 5, 2, hd))
        assert PA.prefill_attention(qs, ks, ks).shape == (1, 5, 4, hd)
    assert PA.launches == before + 3
    assert [(e, a[8]) for e, a in recorded] == [("prefill_attention_launch", hd)
                                                for hd in (264, 384, 512)]


@pytest.mark.parametrize("hd", [384, 512])
def test_decode_attention_plain_matches_pallas_at_twelve_heads_a_group(hd):
    """24 query heads over 2 KV heads at hd 384 and 512: cache_len 1, a
    chunk edge, 0 (the mean of v over the window) and past the window."""
    B, H, KV, W = 4, 24, 2, 96
    rng = np.random.default_rng(hd + 12)
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    kc = rng.standard_normal((B, W, KV, hd)).astype(np.float32)
    vc = rng.standard_normal((B, W, KV, hd)).astype(np.float32)
    cl = np.asarray([1, 33, 0, W + 9], np.int32)
    ref = decode_attention_pallas(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                                  jnp.asarray(cl), block_w=32, interpret=True)
    out = DA.decode_attention(torch.from_numpy(q), torch.from_numpy(kc),
                              torch.from_numpy(vc), torch.from_numpy(cl))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("causal,prefix", [(False, 0), (True, 19)])
def test_prefill_attention_plain_matches_pallas_at_hd_384(causal, prefix):
    """Bidirectional, and causal with a 19-position bidirectional prefix, 8
    query heads over 2 KV heads at hd 384."""
    B, S, H, KV, hd = 1, 70, 8, 2, 384
    rng = np.random.default_rng(S + prefix + int(causal))
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    kw = dict(causal=causal, window=0, prefix_len=prefix)
    ref = prefill_attention_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   bq=32, bk=32, interpret=True, **kw)
    out = PA.prefill_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
