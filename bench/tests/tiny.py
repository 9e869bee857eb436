"""A cell's configuration cut to a size a CPU test run holds: every layer,
path and comparison of the cell, at small widths and a small KB."""
from __future__ import annotations

import copy
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from bench import cells  # noqa: E402

SMALL = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
             vocab_size=512, key_dim=32)


def tiny(name: str, root: Path = ROOT):
    """-> (configuration, the port's model config) of cell ``name`` at test
    size."""
    from bench.serve import port_config
    cfg = copy.deepcopy(cells.find(name, root).config)
    cfg.update(SMALL)
    cfg["corpus"] = dict(cfg["corpus"], topics=8, topic_words=16)
    if cfg["workload"] == "knnlm":
        cfg["datastore_rows"] = 20000
        cfg["corpus"]["heldout_tokens"] = 4096
    else:
        cfg["kb_passages"] = 4000
    return cfg, port_config(cfg)


def run_tiny(name: str, seed: int = 12345678901, seconds: float = 1.0, trace: bool = False,
             ctrl: str = "", root: Path = ROOT):
    import torch
    torch.set_num_threads(2)
    from bench import harness
    cfg, _ = tiny(name, root)
    return harness.run(name, seed, seconds, trace, device="cpu", root=root, config=cfg,
                       ctrl=ctrl)
