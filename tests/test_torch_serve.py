"""The whole slice: the port's serving stack against the reference RaLMSeq.

On the same converted parameters, KB and prompts, the port's RaLMSeq, its
RaLMSpec under every variant, and its FleetServer (3 slots, sync and async) —
all over the ``kernel`` EDR backend, which runs the dense top-k's plain
version on the CPU — must give exactly the tokens of the reference RaLMSeq
(JAX, numpy backend), with one merged KB call per fleet round. Also here: the
CLI's own output check, and the guards that keep the port honest — it loads no
JAX and nothing of the reference package, and it never drops to the CPU by
itself.
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
from repro.launch.serve import make_server as ref_make_server
from repro_torch.configs import RaLMConfig
from repro_torch.launch.serve import build_stack, make_server, variant_config
from repro_torch.models.convert import params_from_reference
from repro_torch.training.data import make_queries

ROOT = Path(__file__).resolve().parents[1]
N_DOCS, MAX_NEW = 1500, 16


@pytest.fixture(scope="module")
def stacks():
    ref = ref_build_stack("edr", n_docs=N_DOCS,
                          rcfg=RefRaLMConfig(max_new_tokens=MAX_NEW))
    port = build_stack("edr", n_docs=N_DOCS, backend="kernel", device="cpu",
                       rcfg=RaLMConfig(max_new_tokens=MAX_NEW))
    port.params = params_from_reference(port.cfg,
                                        jax.tree.map(np.asarray, ref.params))
    assert port.docs == ref.docs
    assert np.array_equal(port.retriever.kb.embeddings, ref.retriever.kb.embeddings)
    prompts = [(q * 12)[:48] for q in make_queries(port.docs, 3)]
    seq = ref_make_server(ref, scheduler="seq")
    want = [seq.serve(p).tokens for p in prompts]
    assert all(len(t) == MAX_NEW for t in want)
    return port, prompts, want


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
        "assert len(mods) >= 20 and not bad, bad\n")
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
    for kw, msg in ((dict(retriever="adr"), "supported: edr"),
                    (dict(retriever="edr", backend="sharded"),
                     "supported: numpy, kernel"),
                    (dict(retriever="edr", workload="knnlm"),
                     "supported: ralm")):
        retriever = kw.pop("retriever")
        with pytest.raises(ValueError, match=msg):
            build_stack(retriever, n_docs=10, device="cpu", **kw)
