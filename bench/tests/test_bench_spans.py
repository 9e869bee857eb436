"""CPU tests of the per-layer metrics that read the program's own spans
(``repro_torch.trace``) against the device trace: each one's arithmetic on
a synthetic traced part, and nothing read where the program has no tracer.

    python -m pytest -q bench/tests
"""
from __future__ import annotations

import builtins

import pytest

from bench import cells, spans
from bench.harness import RunView
from bench.tests.tiny import ROOT
from bench.trace import Trace
from repro_torch import trace

MS = 1_000_000
MAIN, WORKER = 101, 202


def _span(name, id_, parent, t0, t1, thread=MAIN, **attrs):
    return trace.Span(name, id_, parent, thread, t0 * MS, t1 * MS, attrs)


# two rounds in a 100 ms traced part: a prefill, a decode step and a
# speculation interpolation, the first round's call on the worker joined
# for 4 ms, the second's inline for 4 ms (with a verification interpolation
# inside); 10 tokens served; B1's scan runs on the card beside the decode
SPANS = [
    _span("request", 1, 0, 0, 100, rid=0, tokens=4),
    _span("request", 2, 0, 0, 100, rid=1, tokens=6),
    _span("fleet.round", 10, 0, 5, 95),
    _span("engine.prefill", 11, 10, 5, 25),
    _span("engine.prefill.dispatch", 12, 11, 5, 10),
    _span("engine.sync", 13, 11, 10, 25),
    _span("engine.decode", 14, 10, 25, 45),
    _span("engine.dispatch", 15, 14, 25, 28, live=2),
    _span("engine.readback", 16, 14, 28, 45),
    _span("knn.interpolate", 17, 10, 45, 49, role="speculate"),
    _span("fleet.verify", 18, 10, 30, 60, thread=WORKER),
    _span("kb.call", 19, 18, 31, 59, thread=WORKER, B=2, k=8),
    _span("fleet.join", 20, 10, 60, 64),
    _span("fleet.round", 30, 0, 95, 100),
    _span("fleet.verify", 31, 30, 95, 99),
    _span("knn.interpolate", 32, 31, 96, 97, role="verify"),
    _span("engine.dispatch", 40, 0, 150, 160, live=2),       # after the traced part
]
DEVICE = [("gemm_kernel", 10 * MS, 20 * MS),
          ("void scan_kernel<float>(float const*)", 30 * MS, 60 * MS),
          ("gemm_kernel", 70 * MS, 75 * MS)]
WANT = {"decode_dispatch_ms": 3.0, "prefill_dispatch_ms": 5.0, "dispatch_idle_pct": 8.0,
        "verify_wait_ms": 4.0, "model_device_ms_per_tok": 1.0, "interp_ms_per_tok": 0.5}


def _run(device=DEVICE):
    return RunView(cfg={}, window=None, rec=None,
                   trace=Trace(window=(0, 100 * MS), device=list(device)), kb_rows=0)


def _reader(name):
    return cells.load_module(ROOT / "bench" / "metrics" / f"{name}.py",
                             f"test_{name.replace('.', '_')}")


@pytest.fixture
def program_spans(monkeypatch):
    monkeypatch.setattr(trace, "spans", lambda: list(SPANS))


@pytest.mark.parametrize("name", sorted(WANT) + [n + ".ralm" for n in sorted(WANT)
                                                 if n != "interp_ms_per_tok"])
def test_each_metric_reads_the_synthetic_traced_part(program_spans, name):
    mod = _reader(name)
    assert mod.read(_run()) == pytest.approx(WANT[name.split(".")[0]])
    assert mod.MOVES == ("device_ms_per_tok" if name.endswith(".ralm") else "tokens_per_s")


def test_the_span_arithmetic(program_spans):
    sp = spans.of(_run())
    assert len(sp) == len(SPANS) - 1                     # the one after the part left out
    assert spans.tokens(sp) == 10
    assert spans.self_ns(sp, "fleet.verify") == [2 * MS, 3 * MS]
    assert spans.self_ns(sp, "fleet.round") == [42 * MS, 1 * MS]    # the worker's child not
    assert spans.union([(5, 9), (1, 3), (2, 4), (9, 9)]) == [[1, 4], [5, 9]]
    assert spans.overlap_ns([[0, 10], [20, 30]], [[5, 25], [28, 40]]) == 5 + 5 + 2


def test_without_the_spans_the_metrics_read_nothing(monkeypatch):
    monkeypatch.setattr(trace, "spans", lambda: [])
    for name in WANT:
        assert _reader(name).read(_run()) is None
    monkeypatch.setattr(trace, "spans", lambda: list(SPANS))
    assert all(_reader(n).read(RunView({}, None, None, None, 0)) is None for n in WANT)
    real = builtins.__import__

    def no_tracer(name, *a, **kw):          # an older program: no repro_torch.trace
        if name == "repro_torch" and a and a[2] and "trace" in a[2]:
            raise ImportError(name)
        return real(name, *a, **kw)
    monkeypatch.setattr(builtins, "__import__", no_tracer)
    assert all(_reader(n).read(_run()) is None for n in WANT)


def test_the_device_idle_under_dispatch_follows_the_trace(program_spans):
    busy = _reader("dispatch_idle_pct").read(_run(DEVICE + [("k", 0, 100 * MS)]))
    assert busy == 0.0
    assert _reader("model_device_ms_per_tok").read(_run([])) == 0.0
