#!/usr/bin/env python3
"""The benchmark of the PyTorch/CUDA port (``src/repro_torch``): one run of
one cell of ``BENCHMARK.json``, from the root of a checkout:

    python3 bench/run.py --workload knnlm-edr-c8 --seed 7 --seconds 30 --trace 0

Prints one JSON line (the last line of standard output): ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` also
``breakdown``, and last ``checks``. Exits non-zero without a CUDA device.
Every cache the program builds stays inside the checkout, at fixed paths.
"""
import time

T0 = time.monotonic()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(ROOT / "build" / sub)
for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[var] = "4"
os.environ["USE_FLAX"] = "0"
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T0))
