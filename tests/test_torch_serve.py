"""The whole slice: the port's serving stack against the reference RaLMSeq.

On the same converted parameters, KB and prompts, the port's RaLMSeq, its
RaLMSpec under every variant, and its FleetServer (3 slots, sync and async) —
all over the ``kernel`` backend, which runs the kernels' plain versions on the
CPU — must give exactly the tokens of the reference RaLMSeq (JAX, numpy
backend), with one merged KB call per fleet round: for EDR, and for ADR,
whose IVF index must equal the reference's, and for SR (BM25, numpy), whose
ids and scores must equal the reference's byte for byte. Over the inexact
``int8-kernel`` backend the fleet must give the tokens of RaLMSeq through the
same backend object. Also here: the CLI's own output checks (RaLM, SR,
KNN-LM, continuous, injected faults), the capability table against the
reference's, and the guards that keep the port honest — it loads no JAX and
nothing of the reference package, and it never drops to the CPU by itself.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import RaLMConfig as RefRaLMConfig
from repro.launch.serve import build_stack as ref_build_stack
from repro.launch.serve import CAPABILITIES as REF_CAPABILITIES
from repro.launch.serve import make_server as ref_make_server
from repro_torch.configs import RaLMConfig
from repro_torch.launch.serve import (CAPABILITIES, SCHEDULERS, WORKLOADS, build_stack,
                                      make_server, variant_config)
from repro_torch.models.convert import params_from_reference
from repro_torch.retrieval.backends import TorchQuantizedKernelBackend
from repro_torch.retrieval.retrievers import BM25Retriever, IVFRetriever
from repro_torch.training.data import make_queries

# six xdist workers share the host's cores: one torch thread each
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
N_DOCS, MAX_NEW = 1500, 16


def _build_pair(retriever):
    """The reference stack (numpy backend) and the port's (kernel backend,
    CPU) on the reference's parameters, with the reference RaLMSeq's tokens
    for three prompts."""
    ref = ref_build_stack(retriever, n_docs=N_DOCS,
                          rcfg=RefRaLMConfig(max_new_tokens=MAX_NEW))
    port = build_stack(retriever, n_docs=N_DOCS, device="cpu",
                       backend="numpy" if retriever == "sr" else "kernel",
                       rcfg=RaLMConfig(max_new_tokens=MAX_NEW))
    port.params = params_from_reference(port.cfg,
                                        jax.tree.map(np.asarray, ref.params))
    assert port.docs == ref.docs
    if retriever != "sr":
        assert np.array_equal(port.retriever.kb.embeddings, ref.retriever.kb.embeddings)
    prompts = [(q * 12)[:48] for q in make_queries(port.docs, 3)]
    seq = ref_make_server(ref, scheduler="seq")
    want = [seq.serve(p).tokens for p in prompts]
    assert all(len(t) == MAX_NEW for t in want)
    return port, prompts, want, ref


@pytest.fixture(scope="module")
def stacks():
    return _build_pair("edr")[:3]


@pytest.fixture(scope="module")
def adr_stacks():
    return _build_pair("adr")


@pytest.fixture(scope="module")
def sr_stacks():
    return _build_pair("sr")


def _with(stack, variant):
    return dataclasses.replace(stack, engine=None,
                               rcfg=variant_config(variant, stack.rcfg))


def test_port_ralmseq_matches_reference(stacks):
    port, prompts, want = stacks
    seq = make_server(port, scheduler="seq")
    assert [seq.serve(p).tokens for p in prompts] == want


@pytest.mark.parametrize("variant", ["", "p", "s", "a", "psa"])
def test_port_ralmspec_variants_match_reference(stacks, variant):
    port, prompts, want = stacks
    spec = make_server(_with(port, variant), scheduler="single")
    assert [spec.serve(p).tokens for p in prompts] == want


@pytest.mark.parametrize("async_fleet", [False, True])
def test_port_fleet_matches_reference_one_call_per_round(stacks, async_fleet):
    port, prompts, want = stacks
    st = _with(port, "psa")
    backend = st.retriever.backend
    with make_server(st, scheduler="fixed", n_slots=3,
                     async_fleet=async_fleet) as fleet:
        c0 = backend.calls
        fr = fleet.serve(prompts)
    assert [r.tokens for r in fr.results] == want
    assert fr.kb_calls == fr.rounds + 1            # seed call + one per round
    assert backend.calls - c0 == fr.kb_calls
    assert fr.kb_errors == 0 and fr.degraded_rounds == 0


def test_port_ivf_index_equals_reference(adr_stacks):
    """Same k-means (centroids), same bucket table, same candidate matrix."""
    port, prompts, _, ref = adr_stacks
    ours, theirs = port.retriever, ref.retriever
    assert isinstance(ours, IVFRetriever)
    assert np.array_equal(ours.centroids, theirs.centroids)
    assert np.array_equal(ours._bucket_pad, theirs._bucket_pad)
    qs = port.encoder.encode_batch(prompts)
    for k in (1, 20):
        c_ours, n_ours = ours._gather_candidates(qs, k)
        c_ref, n_ref = theirs._gather_candidates(qs, k)
        assert np.array_equal(c_ours, c_ref) and np.array_equal(n_ours, n_ref)
        assert np.array_equal(ours.retrieve(qs, k)[0], theirs.retrieve(qs, k)[0])


def test_port_adr_ralmseq_matches_reference(adr_stacks):
    port, prompts, want, _ = adr_stacks
    seq = make_server(port, scheduler="seq")
    assert [seq.serve(p).tokens for p in prompts] == want


@pytest.mark.parametrize("async_fleet", [False, True])
def test_port_adr_fleet_matches_reference_one_call_per_round(adr_stacks, async_fleet):
    port, prompts, want, _ = adr_stacks
    st = _with(port, "psa")
    backend = st.retriever.backend
    with make_server(st, scheduler="fixed", n_slots=3,
                     async_fleet=async_fleet) as fleet:
        c0 = backend.calls
        fr = fleet.serve(prompts)
    assert [r.tokens for r in fr.results] == want
    assert fr.kb_calls == fr.rounds + 1
    assert backend.calls - c0 == fr.kb_calls


def test_port_bm25_equals_reference_byte_for_byte(sr_stacks):
    """The SparseKB and BM25 ids and scores, single and batched, k = 1, 20
    and more than the corpus holds."""
    port, prompts, _, ref = sr_stacks
    ours, theirs = port.retriever, ref.retriever
    assert isinstance(ours, BM25Retriever)
    assert np.array_equal(ours.kb.terms, theirs.kb.terms)
    assert ours.kb.idf == theirs.kb.idf and ours.kb.avgdl == theirs.kb.avgdl
    queries = [list(p[-32:]) for p in prompts] + [[7, 7, 7], [10**6]]
    for k in (1, 20, N_DOCS + 5):
        a, b = ours.retrieve(queries, k), theirs.retrieve(queries, k)
        assert a[0].dtype == b[0].dtype and a[1].dtype == b[1].dtype
        assert a[0].tobytes() == b[0].tobytes() and a[1].tobytes() == b[1].tobytes()
        one = ours.retrieve(queries[0], k)
        assert np.array_equal(one[0][0], a[0][0])
    assert np.array_equal(ours.keys_of([3, 0]), theirs.keys_of([3, 0]))


def test_port_sr_ralmseq_matches_reference(sr_stacks):
    port, prompts, want, _ = sr_stacks
    seq = make_server(port, scheduler="seq")
    assert [seq.serve(p).tokens for p in prompts] == want


@pytest.mark.parametrize("variant", ["", "psa"])
def test_port_sr_ralmspec_matches_reference(sr_stacks, variant):
    port, prompts, want, _ = sr_stacks
    spec = make_server(_with(port, variant), scheduler="single")
    assert [spec.serve(p).tokens for p in prompts] == want


@pytest.mark.parametrize("async_fleet", [False, True])
def test_port_sr_fleet_matches_reference_one_call_per_round(sr_stacks, async_fleet):
    port, prompts, want, _ = sr_stacks
    st = _with(port, "psa")
    with make_server(st, scheduler="fixed", n_slots=3,
                     async_fleet=async_fleet) as fleet:
        c0 = st.retriever.stats.calls
        fr = fleet.serve(prompts)
    assert [r.tokens for r in fr.results] == want
    assert fr.kb_calls == fr.rounds + 1 == st.retriever.stats.calls - c0


@pytest.mark.parametrize("retriever", ["edr", "adr"])
def test_port_int8_kernel_fleet_matches_ralmseq(stacks, adr_stacks, retriever):
    """The inexact backend's contract: speculation + batched verification
    through one int8-kernel backend object give RaLMSeq's tokens through it."""
    port, prompts, _ = stacks if retriever == "edr" else adr_stacks[:3]
    qb = TorchQuantizedKernelBackend(port.retriever.kb.embeddings, device="cpu")
    retr = (type(port.retriever)(port.retriever.kb, backend=qb))
    st = dataclasses.replace(_with(port, "psa"), retriever=retr, backend="int8-kernel")
    seq = make_server(st, scheduler="seq")
    base = [seq.serve(p).tokens for p in prompts]
    with make_server(st, scheduler="fixed", n_slots=3) as fleet:
        c0 = qb.calls
        fr = fleet.serve(prompts)
    assert [r.tokens for r in fr.results] == base
    assert fr.kb_calls == fr.rounds + 1 and qb.calls - c0 == fr.kb_calls


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_cli_outputs_identical():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--mode", "both", "--concurrency", "2", "--requests", "2",
         "--max-new", "8", "--n-docs", "1000", "--retriever-backend", "kernel"],
        cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "outputs identical: True" in out.stdout, out.stdout


@pytest.mark.parametrize("args,expect", [
    (["--retriever", "sr"], "outputs identical: True"),
    (["--workload", "knnlm", "--retriever-backend", "kernel", "--n-docs", "200"],
     "outputs token-match: True"),
    (["--scheduler", "continuous", "--arrival-rate", "50", "--retriever", "adr",
      "--retriever-backend", "kernel"], "outputs identical: True"),
    (["--mode", "spec", "--inject-faults", "p_error=0.3,seed=3", "--retry-max", "4",
      "--retriever-backend", "kernel"], "fault injection: "),
], ids=["sr", "knnlm", "continuous", "faults"])
def test_cli_serves_sr_knnlm_continuous_and_faults(args, expect):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--mode", "both", "--concurrency", "2", "--requests", "2",
         "--max-new", "8", "--n-docs", "1000", *args],
        cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert expect in out.stdout, out.stdout


@pytest.mark.parametrize("args,message", [
    (["--mesh-shards", "-1", "--retriever-backend", "sharded"], "--mesh-shards must be >= 0"),
    (["--inject-faults", "p_error=lots", "--mode", "spec", "--concurrency", "2"],
     "--inject-faults"),
    (["--inject-faults", "p_error=0.1", "--concurrency", "2"], "--mode spec"),
    (["--inject-faults", "p_error=0.1", "--mode", "spec"], "fleet scheduler"),
    (["--scheduler", "continuous", "--arrival-trace", "0,zap"],
     "malformed arrival time"),
    (["--workload", "knnlm", "--retriever", "sr"], "supported: edr, adr"),
])
def test_cli_refuses_with_one_line(args, message):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu", *args],
        cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=300)
    assert out.returncode == 2 and message in out.stderr, out.stderr


def test_port_imports_no_jax_and_nothing_of_the_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.')]\n"
        "for name in mods:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(len(mods), bad)\n"
        "assert len(mods) >= 20 and not bad, bad\n"
        "assert {'repro_torch.core.knnlm', 'repro_torch.serving.continuous', "
        "'repro_torch.retrieval.faults', 'repro_torch.models.moe', "
        "'repro_torch.models.ssm', 'repro_torch.retrieval.sharded', "
        "'repro_torch.training.optimizer', 'repro_torch.training.trainer', "
        "'repro_torch.training.checkpoint', 'repro_torch.launch.train'} "
        "<= set(mods), mods\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_no_silent_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_stack("edr", n_docs=10, device="cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_stack("edr", n_docs=10)              # CUDA is the default


def test_capability_table_names_what_is_supported():
    """The table is the reference's, the sharded backends included, and
    every rejection names the supported set."""
    assert CAPABILITIES == REF_CAPABILITIES
    assert WORKLOADS == ("ralm", "knnlm")
    assert SCHEDULERS == ("seq", "single", "fixed", "continuous")
    for kw, msg in ((dict(retriever="sr", workload="knnlm"), "supported: edr, adr"),
                    (dict(retriever="sr", backend="kernel"), r"supported: numpy\)$"),
                    (dict(retriever="sr", backend="sharded"), r"supported: numpy\)$"),
                    (dict(retriever="edr", backend="faiss"),
                     "supported: numpy, kernel, sharded, int8, int8-kernel, int8-sharded"),
                    (dict(retriever="adr", workload="knnlm", backend="int8-shard"),
                     "supported: numpy, kernel, sharded, int8, int8-kernel, int8-sharded"),
                    (dict(retriever="edr", workload="moe"),
                     "supported: ralm, knnlm")):
        retriever = kw.pop("retriever")
        with pytest.raises(ValueError, match=msg):
            build_stack(retriever, n_docs=10, device="cpu", **kw)
    st = build_stack("adr", n_docs=200, backend="int8-kernel", device="cpu")
    assert isinstance(st.retriever, IVFRetriever)
    assert st.retriever.backend.name == "int8-kernel"
    for retriever, workload, backend in (("edr", "ralm", "sharded"),
                                         ("adr", "ralm", "int8-sharded"),
                                         ("edr", "knnlm", "sharded")):
        sh = build_stack(retriever, n_docs=200, workload=workload, backend=backend,
                         mesh_shards=3, knn_entries=500, device="cpu")
        assert sh.retriever.backend.name == backend and sh.retriever.backend.n_shards == 3
    with pytest.raises(ValueError, match="fixed, continuous"):
        make_server(st, scheduler="sharded")
    st = build_stack("sr", n_docs=50, device="cpu")
    assert isinstance(st.retriever, BM25Retriever) and not st.rcfg.knnlm
    st = build_stack("adr", n_docs=50, workload="knnlm", knn_entries=500,
                     backend="kernel", device="cpu")
    assert st.rcfg.knnlm and st.retriever.kb.values.shape == (500,)
    assert st.workload.name == "knnlm" and st.stream.dtype == np.int32
