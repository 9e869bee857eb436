"""The port's serving examples run end to end on the CPU, each in a
subprocess under a timeout, and report the speculative server's tokens
identical to the baseline's (token-match for KNN-LM), as the reference's
examples do."""
import os
import subprocess
import sys

import pytest
import torch

# six xdist workers share the host's cores: one torch thread each (and in
# each example's process)
torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")


@pytest.mark.parametrize("name,want", [
    ("quickstart_torch.py", ["outputs identical: True"]),
    ("ralm_serving_torch.py", [f"{r}: baseline" for r in ("EDR", "ADR", "SR ")]),
    ("knnlm_serving_torch.py", ["ralmspec :", "fleet x3 :"]),
])
def test_example_outputs_identical(name, want):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, os.path.join(ROOT, "examples", name),
                          "--device", "cpu"], capture_output=True, text=True,
                         timeout=300, env=env)
    assert out.returncode == 0, out.stdout + out.stderr
    tag = "outputs identical (token-match)" if name.startswith("knnlm") else "outputs identical"
    for w in want:
        lines = [ln for ln in out.stdout.splitlines() if ln.startswith(w)]
        assert len(lines) == 1 and tag in lines[0], (w, out.stdout)
