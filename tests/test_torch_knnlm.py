"""KNN-LM serving of the port against the reference (paper §5.3).

The same seeded inputs go through the reference and the port: the
interpolation (numpy float64 on the host in both), the datastore build, and
then whole servers on parameters converted from the reference pytree. The
port's KNNLMSeq and KNNLMSpec, and its fleet (sync and async) and continuous
KNN-LM servers on the numpy and ``kernel`` backends (the kernels' plain
versions on the CPU), must give exactly the reference KNNLMSeq's tokens, with
one merged KB call per fleet round (plus one seed call, or the continuous
server's batched seed calls), mirroring
``tests/test_output_preservation.py::test_knnlm_serving_preservation``.
Every comparison is exact: the outputs are tokens, ids and counters.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import RaLMConfig as RefRaLMConfig
from repro.core.knnlm import knn_interpolate as ref_knn_interpolate
from repro.launch.serve import build_stack as ref_build_stack
from repro.launch.serve import make_server as ref_make_server
from repro.retrieval.encoder import ContextEncoder as RefEncoder
from repro.retrieval.kb import build_knn_datastore as ref_build_knn_datastore
from repro.retrieval.retrievers import IVFRetriever as RefIVF
from repro_torch.configs import RaLMConfig
from repro_torch.core.knnlm import KNNLMSeq, KNNLMSpec, knn_interpolate
from repro_torch.launch.serve import build_stack, make_server, variant_config
from repro_torch.models.convert import params_from_reference
from repro_torch.retrieval.encoder import ContextEncoder
from repro_torch.retrieval.kb import build_knn_datastore
from repro_torch.retrieval.retrievers import ExactDenseRetriever, IVFRetriever
from repro_torch.serving.continuous import as_requests
from repro_torch.serving.workload import KNNLMWorkload

# six xdist workers share the host's cores: one torch thread each
torch.set_num_threads(1)

N_DOCS, ENTRIES, MAX_NEW = 300, 6000, 16


# ---------------------------------------------------------------------------------
# the interpolation and the datastore
# ---------------------------------------------------------------------------------
@pytest.mark.parametrize("case", ["gaussian", "pads", "all_pad", "duplicates", "ties"])
def test_knn_interpolate_matches_reference(case):
    rng = np.random.default_rng(["gaussian", "pads", "all_pad", "duplicates",
                                 "ties"].index(case))
    V, k = 512, 8
    for _ in range(20):
        logits = (rng.standard_normal(V) * 3).astype(np.float32)
        values = rng.integers(0, V, k).astype(np.int32)
        scores = rng.uniform(-1, 1, k).astype(np.float32)
        if case == "pads":
            values[rng.random(k) < 0.5] = -1
        elif case == "all_pad":
            values[:] = -1
        elif case == "duplicates":
            values[:] = values[0]
        elif case == "ties":
            logits = np.round(logits).astype(np.float32)
            scores[:] = scores[0]
        for lam in (0.0, 0.25, 1.0):
            assert knn_interpolate(logits, values, scores, lam) == \
                ref_knn_interpolate(logits, values, scores, lam)


@pytest.mark.parametrize("context,stride,limit", [(16, 1, 5000), (8, 3, None),
                                                  (16, 1, None)])
def test_build_knn_datastore_equals_reference(context, stride, limit):
    rng = np.random.default_rng(context + stride)
    stream = rng.integers(2, 512, 3000).astype(np.int32)
    ours = build_knn_datastore(stream, ContextEncoder(512, d=32, window=16),
                               context=context, stride=stride, limit=limit)
    ref = ref_build_knn_datastore(stream, RefEncoder(512, d=32, window=16),
                                  context=context, stride=stride, limit=limit)
    assert ours.embeddings.dtype == ref.embeddings.dtype
    assert ours.embeddings.tobytes() == ref.embeddings.tobytes()
    assert ours.values.dtype == ref.values.dtype
    assert ours.values.tobytes() == ref.values.tobytes()
    assert ours.docs == ref.docs


# ---------------------------------------------------------------------------------
# whole servers on converted parameters
# ---------------------------------------------------------------------------------
@pytest.fixture(scope="module")
def knn():
    """The reference KNN-LM stack and its KNNLMSeq tokens for three prompts
    (spans of the stream, as the reference CLI builds them), and the port's
    stack on the reference's parameters with the ``kernel`` backend."""
    rcfg = dict(max_new_tokens=MAX_NEW, speculation_stride=3)
    ref = ref_build_stack("edr", n_docs=N_DOCS, workload="knnlm",
                          knn_entries=ENTRIES, rcfg=RefRaLMConfig(**rcfg))
    port = build_stack("edr", n_docs=N_DOCS, workload="knnlm", knn_entries=ENTRIES,
                       backend="kernel", device="cpu", rcfg=RaLMConfig(**rcfg))
    port.params = params_from_reference(port.cfg, jax.tree.map(np.asarray, ref.params))
    assert port.rcfg.knnlm and isinstance(port.workload, KNNLMWorkload)
    assert np.array_equal(port.stream, ref.stream)
    assert port.retriever.kb.embeddings.tobytes() == ref.retriever.kb.embeddings.tobytes()
    assert np.array_equal(port.retriever.kb.values, ref.retriever.kb.values)
    prompts = [port.stream[i * 97:i * 97 + 48].tolist() for i in range(3)]
    seq = ref_make_server(ref, scheduler="seq")
    want = [seq.serve(p).tokens for p in prompts]
    assert all(len(t) == MAX_NEW for t in want)
    return port, prompts, want, ref


def _retriever(port, kind, backend):
    kb = port.retriever.kb
    if kind == "edr":
        return ExactDenseRetriever(kb, backend=backend, device="cpu")
    return IVFRetriever(kb, backend=backend, device="cpu")


@pytest.mark.parametrize("backend", ["numpy", "kernel"])
def test_port_knnlmseq_matches_reference(knn, backend):
    port, prompts, want, _ = knn
    retr = _retriever(port, "edr", backend)
    st = dataclasses.replace(port, retriever=retr, backend=backend, engine=None)
    seq = make_server(st, scheduler="seq")
    assert isinstance(seq, KNNLMSeq)
    res = [seq.serve(p) for p in prompts]
    assert [r.tokens for r in res] == want
    assert all(r.kb_calls == MAX_NEW for r in res)     # one scan per token


@pytest.mark.parametrize("variant", ["", "p", "psa"])
def test_port_knnlmspec_matches_reference(knn, variant):
    port, prompts, want, _ = knn
    st = dataclasses.replace(port, engine=None, rcfg=variant_config(variant, port.rcfg))
    spec = make_server(st, scheduler="single")
    assert isinstance(spec, KNNLMSpec)
    res = [spec.serve(p) for p in prompts]
    assert [r.tokens for r in res] == want
    assert all(r.kb_calls == r.rounds + 1 for r in res)


@pytest.mark.parametrize("backend", ["numpy", "kernel"])
@pytest.mark.parametrize("mode", ["fleet", "async", "continuous"])
def test_port_knnlm_fleet_paths_match_reference(knn, mode, backend):
    """Fleet, async fleet (forced-open gate, full-stride overlap, as in the
    reference's test) and continuous KNN-LM serving over three slots: the
    reference KNNLMSeq's tokens, one merged KB call per round."""
    port, prompts, want, _ = knn
    rcfg = port.rcfg
    if mode == "async":
        rcfg = dataclasses.replace(rcfg, async_verification=True,
                                   async_gate_ratio=0.0, async_min_overlap=4)
    retr = _retriever(port, "edr", backend)
    st = dataclasses.replace(port, retriever=retr, backend=backend, rcfg=rcfg,
                             engine=None)
    sched = "continuous" if mode == "continuous" else "fixed"
    with make_server(st, scheduler=sched, n_slots=3) as srv:
        fr = srv.serve(as_requests(prompts) if mode == "continuous" else prompts)
    assert [r.tokens for r in fr.results] == want
    if mode == "continuous":
        assert fr.kb_calls == fr.rounds + fr.seed_calls
    else:
        assert fr.kb_calls == fr.rounds + 1
    assert retr.stats.calls == fr.kb_calls
    if mode == "async":
        assert sum(r.carry_steps + r.carry_invalidations for r in fr.results) > 0


@pytest.mark.parametrize("backend", ["numpy", "kernel"])
def test_port_knnlm_adr_fleet_matches_its_seq(knn, backend):
    """KNN-LM over the IVF probe: the fleet token-matches KNNLMSeq through
    the same retriever, and the port's ADR KNNLMSeq gives the reference's."""
    port, prompts, _, ref = knn
    retr = _retriever(port, "adr", backend)
    st = dataclasses.replace(port, retriever=retr, retriever_kind="adr",
                             backend=backend, engine=None)
    ref_adr = dataclasses.replace(ref, retriever=RefIVF(ref.retriever.kb),
                                  retriever_kind="adr")     # the fixture's engine
    want = [ref_make_server(ref_adr, scheduler="seq").serve(p).tokens for p in prompts]
    seq = [make_server(st, scheduler="seq").serve(p).tokens for p in prompts]
    assert seq == want
    with make_server(st, scheduler="fixed", n_slots=3) as fleet:
        fr = fleet.serve(prompts)
    assert [r.tokens for r in fr.results] == want
    assert fr.kb_calls == fr.rounds + 1


def test_knnlm_workload_refuses_a_kb_without_values(knn):
    port = knn[0]
    ralm = build_stack("edr", n_docs=50, device="cpu")
    st = dataclasses.replace(port, retriever=ralm.retriever, engine=None)
    with pytest.raises(ValueError, match="value-carrying datastore"):
        make_server(st, scheduler="seq")
    with pytest.raises(ValueError, match="value-carrying datastore"):
        make_server(st, scheduler="fixed", n_slots=2)
