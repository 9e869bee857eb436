#!/usr/bin/env python3
"""The readings that the limits of ``limits/<cell>.json`` are set from, on
the chip at the cell's own size: for each seed, one run of the cell (a
short window at the cell's load) whose program numbers give the lower
reading, and the control's numbers (the plain reference in TF32, the
precision below the configuration's, put in the program's place) the upper
one. The control's numbers are judged by the cell's limits as the
program's are (``ctrl_correct``, which has to come out false). The
benchmark's own runs do not run the control.

    python3 bench/control.py --workload knnlm-edr-c8 --seconds 10 --seeds 11,12,13

One JSON line a seed; all seeds in one process.
"""
import argparse
import gc
import json
import sys
import time
from pathlib import Path

T0 = time.monotonic()
ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main() -> int:
    import torch
    from bench import harness
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    for s in args.seeds.split(","):
        t0 = time.monotonic()
        out = harness.run(args.workload, int(s), args.seconds, False, ctrl="tf32", t0=t0)
        print(json.dumps({"workload": args.workload, "seed": int(s), "correct": out["correct"],
                          "ctrl_correct": out["ctrl_correct"],
                          "attempted": out["attempted"], "readings": out["readings"],
                          "metrics": out["metrics"]}), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
