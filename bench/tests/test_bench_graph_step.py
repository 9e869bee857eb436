"""CPU tests of ``graph_step_pct``: the share of the traced part's
``engine.dispatch`` spans that replayed a CUDA graph, and nothing read where
the program's dispatch spans carry no ``graph`` attribute.

    python -m pytest -q bench/tests
"""
from __future__ import annotations

import pytest

from bench import cells
from bench.harness import RunView
from bench.tests.tiny import ROOT
from bench.trace import Trace
from repro_torch import trace

MS = 1_000_000


def _dispatch(id_, t0, **attrs):
    return trace.Span("engine.dispatch", id_, 0, 101, t0 * MS, (t0 + 2) * MS,
                      dict(live=8, **attrs))


# four steps in a 100 ms traced part: the first eager (it captured the graph),
# three replays, one of which copied state in; a fifth step after the part
STEPS = [_dispatch(1, 10, graph=0, copied=0), _dispatch(2, 20, graph=1, copied=1),
         _dispatch(3, 30, graph=1, copied=0), _dispatch(4, 40, graph=1, copied=0),
         trace.Span("engine.prefill", 5, 0, 101, 50 * MS, 60 * MS, {}),
         _dispatch(6, 150, graph=0, copied=0)]


def _run():
    return RunView(cfg={}, window=None, rec=None,
                   trace=Trace(window=(0, 100 * MS), device=[]), kb_rows=0)


@pytest.mark.parametrize("name,moves", [("graph_step_pct", "tokens_per_s"),
                                        ("graph_step_pct.ralm", "device_ms_per_tok")])
def test_graph_step_pct_reads_the_share_of_replayed_steps(monkeypatch, name, moves):
    mod = cells.load_module(ROOT / "bench" / "metrics" / f"{name}.py",
                            f"test_{name.replace('.', '_')}")
    assert (mod.LAYER, mod.UNIT, mod.BETTER, mod.SOURCE, mod.MOVES) == (
        "engines", "%", "higher", "program_span", moves)
    monkeypatch.setattr(trace, "spans", lambda: list(STEPS))
    assert mod.read(_run()) == pytest.approx(75.0)
    # a program without the graph counter: dispatch spans with no graph attribute
    bare = [s._replace(attrs={"live": 8}) if s.name == "engine.dispatch" else s
            for s in STEPS]
    monkeypatch.setattr(trace, "spans", lambda: bare)
    assert mod.read(_run()) is None
    monkeypatch.setattr(trace, "spans", lambda: [])
    assert mod.read(_run()) is None
    assert mod.read(RunView({}, None, None, None, 0)) is None
