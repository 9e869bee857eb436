"""``model_device_ms_per_tok``, read as ``metrics/model_device_ms_per_tok.py`` reads it, in the cells
whose end-to-end rate is the card's time a token (``device_ms_per_tok``)."""
from pathlib import Path

from bench.cells import load_module

_BASE = load_module(Path(__file__).with_name("model_device_ms_per_tok.py"), "bench_metric_model_device_ms_per_tok")
LAYER, UNIT, BETTER, SOURCE = _BASE.LAYER, _BASE.UNIT, _BASE.BETTER, _BASE.SOURCE
MOVES = "device_ms_per_tok"
read = _BASE.read
