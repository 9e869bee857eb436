"""CPU tests of the benchmark: run with python -m pytest -q bench/tests."""
