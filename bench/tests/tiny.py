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


def small(cfg: dict) -> dict:
    """A configuration at test size: ``SMALL``'s widths, and a stated
    ``moe``, ``ssm`` or ``block_pattern`` cut as the port's
    ``configs.reduced`` cuts them: at most 4 experts of width 2 d, top-2 and
    one shared expert; scan chunks of 32; each mixer kind of the pattern
    once, in its order."""
    cfg = dict(copy.deepcopy(cfg), **SMALL)
    d = SMALL["d_model"]
    if "moe" in cfg:
        m = cfg["moe"]
        cfg["moe"] = dict(m, num_experts=min(4, m["num_experts"]), top_k=min(2, m["top_k"]),
                          d_expert=2 * d, num_shared_experts=min(1, m.get("num_shared_experts", 0)),
                          dispatch_chunk=64)
    if "ssm" in cfg:
        cfg["ssm"] = dict(cfg["ssm"], chunk=32)
    if "block_pattern" in cfg:
        kinds = list(dict.fromkeys(cfg["block_pattern"]))
        cfg["block_pattern"] = (kinds * SMALL["num_layers"])[:SMALL["num_layers"]]
    return cfg


def tiny(name: str, root: Path = ROOT):
    """-> (configuration, the port's model config) of cell ``name`` at test
    size (``small``, and a small corpus and KB)."""
    from bench.serve import port_config
    cfg = small(cells.find(name, root).config)
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
