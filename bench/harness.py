"""One run of one cell: set-up, warm-up, the measured window, the
comparison with the plain reference, and the result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

With ``--trace 0`` the result's metrics are the cell's end-to-end ones
(``setup_s``, and ``tokens_per_s`` or ``device_ms_per_tok``); with
``--trace 1`` its per-layer ones, read by ``metrics/<name>.py`` from the
run's counters, the benchmark's spans and the profiler trace of the groups
served after the window. Every run ends with the
comparison that decides ``correct`` (``bench.judge``), its numbers and limits
as the last lines on standard error and as the result's last key.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import sys
import time
from dataclasses import dataclass

import torch

from bench import cells, data, judge, nvml, serve
from bench.trace import reduce

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclass
class RunView:
    """What a per-layer metric reads."""

    cfg: dict
    window: object
    rec: object
    trace: object
    kb_rows: int


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _profiler(cuda: bool):
    acts = [torch.profiler.ProfilerActivity.CUDA if cuda else torch.profiler.ProfilerActivity.CPU]
    return torch.profiler.profile(activities=acts)


def run(name: str, seed: int, seconds: float, trace: bool, *, device="cuda",
        root=cells.ROOT, config=None, ctrl: str = "", t0=None) -> dict:
    """One run; -> the result dict (and, with ``ctrl``, ``readings`` with the
    control's numbers and ``ctrl_correct``, the control judged by the same
    limits). ``config`` replaces the cell's configuration (tests run a
    small one)."""
    t0 = time.monotonic() if t0 is None else t0
    import repro_torch  # noqa: F401  (fails first where the program is absent)
    cell = cells.find(name, root)
    cfg = config or cell.config
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    corpus = data.Corpus(cfg, seed, dev)
    log(f"{name}: inputs made at {time.monotonic() - t0:.1f} s")
    rec = serve.Recorder(seed)
    clients = int(cell.mix["clients"])
    stack, eng = serve.build(cfg, corpus, dev, rec, clients)
    from repro_torch.launch.serve import make_server
    server = make_server(stack, scheduler="fixed", n_slots=clients,
                         cache_window=cfg["cache_window"], engine=eng)
    log(f"{name}: stack built at {time.monotonic() - t0:.1f} s")
    groups = cell.generator.groups(cell.mix, corpus, seed)
    serve.serve_group(server, eng, next(groups))                 # warm-up group
    log(f"{name}: warm-up group served at {time.monotonic() - t0:.1f} s")
    retr = stack.retriever
    meter = None
    if any(m["name"] == "device_ms_per_tok" for m in cell.end_to_end):
        meter = nvml.BusyMeter(nvml.nvml_index(dev))
    w = serve.run_window(server, eng, retr, groups, seconds, dev, rec, meter)
    setup_s = w.start - t0
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    log(f"{name}: window {w.seconds:.3f} s, {len(w.groups)} groups, {w.tokens} tokens, "
        f"set-up {setup_s:.3f} s, device peak {peak / 2**30:.2f} GiB")
    log(f"{name}: per group wall s {[round(g['wall'], 3) for g in w.groups]}, rounds "
        f"{[g['rounds'] for g in w.groups]}, prefills {[g['prefills'] for g in w.groups]}")
    if w.busy_s is not None:
        log(f"{name}: the card busy {w.busy_s:.3f} s of the window (NVML), "
            f"{1000 * w.busy_s / max(w.tokens, 1):.4f} ms a token, {w.tokens / w.seconds:.4f} "
            "tokens/s")
    tr = None
    if trace:
        t_tr = time.monotonic()
        with serve.traced_layers(rec, server):
            prof, part = serve.run_traced(server, eng, groups, dev, rec, _profiler(cuda))
        tr, inside = reduce(prof, part, rec.spans)
        del prof
        log(f"{name}: traced part {tr.window_s:.3f} s, {len(tr.device)} device intervals, "
            f"{len(tr.spans)} spans, {inside:.1%} of kernel launches inside a span, "
            f"{time.monotonic() - t_tr:.1f} s with the profiler")
    view = RunView(cfg=cfg, window=w, rec=rec, trace=tr, kb_rows=len(corpus.keys))
    metrics = {}
    if trace:
        for entry, reader in cell.per_layer:
            v = reader.read(view)
            if v is not None:
                metrics[entry["name"]] = {"value": float(v), "unit": entry["unit"]}
    else:
        e2e = {"tokens_per_s": w.tokens / w.seconds, "setup_s": setup_s}
        if w.busy_s is not None and w.tokens:
            e2e["device_ms_per_tok"] = 1000.0 * w.busy_s / w.tokens
        for entry in cell.end_to_end:
            if entry["name"] in e2e:
                metrics[entry["name"]] = {"value": float(e2e[entry["name"]]),
                                          "unit": entry["unit"]}
    attempted = len(w.requests)
    failed = sum(1 for r in w.requests
                 if r["status"] != "ok" or len(r["tokens"]) != r["max_new"])

    server.close()
    del server, stack, eng, retr, rec
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        log(f"{name}: program state freed, {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
            "left on the card (the run's weights)")
    t_ref = time.monotonic()
    numbers = judge.readings(cfg, corpus, w.requests, w.kb_sample, w.logit_sample, seed, dev,
                             4 * cell.limits["logit_err"]["limit"], ctrl)
    log(f"{name}: reference in {time.monotonic() - t_ref:.1f} s; widest gap of a served "
        f"token {numbers['token_gap']!r}")
    correct, checks = judge.verdict(numbers, cell.limits, attempted, failed)
    device_info = {"platform": "gpu" if cuda else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if cuda else "host",
                   "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": device_info}
    if trace:
        device_info.update(busy_s=tr.busy_s, window_s=tr.window_s)
        out["breakdown"] = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_by_label()}
    if ctrl:
        out["readings"] = numbers
        out["ctrl_correct"] = judge.verdict(numbers, cell.limits, attempted, failed,
                                            prefix="ctrl_")[0]
    out["checks"] = checks
    del corpus
    gc.collect()
    return out


def main(argv, t0: float) -> int:
    ap = argparse.ArgumentParser(prog="bench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    chips = cells.find(args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"{args.workload} needs {chips} CUDA device(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    out = run(args.workload, args.seed, args.seconds, bool(args.trace), t0=t0)
    bad = forbidden_modules()
    if bad:
        log(f"the run loaded {', '.join(bad)}: the benchmark may load neither JAX nor "
            "the JAX package")
        return 3
    for k, c in out["checks"].items():
        log(f"check {k} = {c['value']!r} (limit {c['limit']!r}) "
            f"{'ok' if c['value'] <= c['limit'] else 'FAILED'}")
    for c in out["checks"].values():         # JSON has no infinity: unreadable is null
        if not math.isfinite(c["value"]):
            c["value"] = None
    print(json.dumps(out), flush=True)
    return 0
