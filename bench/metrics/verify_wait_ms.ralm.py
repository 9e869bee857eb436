"""``verify_wait_ms``, read as ``metrics/verify_wait_ms.py`` reads it, in the cells
whose end-to-end rate is the card's time a token (``device_ms_per_tok``)."""
from pathlib import Path

from bench.cells import load_module

_BASE = load_module(Path(__file__).with_name("verify_wait_ms.py"), "bench_metric_verify_wait_ms")
LAYER, UNIT, BETTER, SOURCE = _BASE.LAYER, _BASE.UNIT, _BASE.BETTER, _BASE.SOURCE
MOVES = "device_ms_per_tok"
read = _BASE.read
