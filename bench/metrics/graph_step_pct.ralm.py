"""``graph_step_pct``, read as ``metrics/graph_step_pct.py`` reads it, in the cells
whose end-to-end rate is the card's time a token (``device_ms_per_tok``)."""
from pathlib import Path

from bench.cells import load_module

_BASE = load_module(Path(__file__).with_name("graph_step_pct.py"), "bench_metric_graph_step_pct")
LAYER, UNIT, BETTER, SOURCE = _BASE.LAYER, _BASE.UNIT, _BASE.BETTER, _BASE.SOURCE
MOVES = "device_ms_per_tok"
read = _BASE.read
