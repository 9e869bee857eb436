"""Finding a cell's pieces by name: ``BENCHMARK.json`` names each cell's
configuration and traffic mix and each metric; every piece is a file of its
own under ``bench/``, so a later change adds a configuration, a mix, a metric
or a cell's limits by adding files and entries, without editing a file that
is there:

  * ``configs/<config>.json``     the configuration as it is run
                                  (``BENCHMARK.json`` ``configs[].file``);
  * ``traffic/<mix>.json``        the mix's parameters, naming its generator
                                  module ``traffic/<generator>.py``;
  * ``metrics/<metric>.py``       one reader per per-layer metric;
  * ``limits/<cell>.json``        the limits of the numbers that decide the
                                  cell's ``correct``.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    generator: object
    limits: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)   # (entry, reader module)


def load_module(path: Path, name: str):
    """A module from a file, by path (the bench's data-driven pieces)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _for(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def find(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s ``BENCHMARK.json``, with its pieces
    loaded from their files."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r}; known: {sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    bdir = root / "bench"
    mix = json.loads((bdir / "traffic" / f"{w['traffic']}.json").read_text())
    gen = load_module(bdir / "traffic" / f"{mix['generator']}.py",
                      f"bench_traffic_{mix['generator']}")
    limits = json.loads((bdir / "limits" / f"{name}.json").read_text())
    readers = [(m, load_module(bdir / "metrics" / f"{m['name']}.py",
                               f"bench_metric_{m['name'].replace('.', '_')}"))
               for m in bench["per_layer"] if _for(m, name)]
    return Cell(name=name, chips=int(w["chips"]), config=config, mix=mix, generator=gen,
                limits=limits, end_to_end=[m for m in bench["end_to_end"] if _for(m, name)],
                per_layer=readers)
