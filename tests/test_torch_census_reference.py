"""The port's dry-run records held against the reference's for the same
pairs: ``repro.launch.dryrun.dryrun_pair`` (XLA on the 512-device host
platform, in a subprocess, as tests/test_distributed.py runs it) beside
``repro_torch.launch.dryrun.dryrun_pair`` (DTensor on the fake group, in a
second subprocess).

The two records count different programs, and the bands below say by how
much (the gaps, pair by pair, are in PERF.md section 6):

* ``argument_bytes``: the same tensors under the same specs, equal to the
  byte (less the decode position's 4 bytes where the step reads it).
* ``output_bytes``: XLA's compiled step returns every output whole (its
  output shardings are all replicated: the reference's ``jit`` gives no
  ``out_shardings``), so its figure is the global bytes of the step's
  outputs, which the test computes from the port's step on plain meta
  tensors. The port keeps each output in the placement DTensor propagates
  (the decode caches split as their inputs), so its figure is at most that.
* the collective kinds: every kind the reference's HLO holds is in the
  port's census.
* ``total_bytes`` and per-device FLOPs: XLA counts each HLO instruction
  once, and the reference's layers run in a ``while`` loop over stacked
  weights, so one layer's collectives and FLOPs stand for all of them; the
  port's census counts every collective each layer issues. Inside that
  loop XLA gathers each layer's weights whole and, on the decode pairs,
  each layer's K/V cache whole (HLO ops named ``squeeze``: the layer's
  slice of the stacked cache), where DTensor keeps them split. XLA also
  counts elementwise ops as FLOPs; the port counts matrix products. So a
  prefill pair's bytes agree within a small factor, and a decode pair's
  reference bytes are dominated by the cache gathers: the port's total is
  held to the reference's with those gathers taken out.

Run as a script to print the comparison table:
    PYTHONPATH=src python tests/test_torch_census_reference.py
"""
import json
import os
import subprocess
import sys

import pytest

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
PAIRS = [(arch, shape, mp) for mp in (False, True)
         for arch, shape in (("llama3.2-1b", "prefill_32k"), ("llama3.2-1b", "decode_32k"),
                             ("llama3.2-1b", "long_500k"), ("xlstm-350m", "long_500k"))]

# each subprocess keeps to one core, as a test worker does
_ONE_CORE = "import os; os.sched_setaffinity(0, {min(os.sched_getaffinity(0))})\n"

_REFERENCE = _ONE_CORE + r"""
import json, os, re, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
from repro.launch import dryrun as D
hlos = []
census = D.collective_census
D.collective_census = lambda hlo: (hlos.append(hlo), census(hlo))[1]
for arch, shape, mp in json.loads(sys.argv[1]):
    rec = D.dryrun_pair(arch, shape, multi_pod=mp, verbose=False)
    rec.pop("traceback", None)
    # the all-gathers of each layer's slice of the stacked cache (squeeze)
    rec["cache_gather_bytes"] = 0
    for line in hlos[-1].splitlines():
        m = re.match(r"(?:ROOT )?%?[\w.\-]+\s*=\s*(.+?)\s*(all-gather)(-start)?[\d.]*\(",
                     line.strip())
        if m and '/squeeze"' in line:
            rec["cache_gather_bytes"] += sum(D._shape_bytes(dt, dims)
                                             for dt, dims in D._SHAPE_RE.findall(m.group(1)))
    print("RECORD", json.dumps(rec), flush=True)
"""

_PORT = _ONE_CORE + r"""
import json, sys, torch
torch.set_num_threads(1)
from repro_torch.launch.dryrun import dryrun_pair
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import make_step
from repro_torch.tree import tree_leaves
for arch, shape, mp in json.loads(sys.argv[1]):
    # greedy pricing for prefill on 2 x 16 x 16, where DTensor's graph
    # search takes ~10 minutes and gives this pair the same record
    pricing = "greedy" if mp and shape == "prefill_32k" else "graph"
    rec = dryrun_pair(arch, shape, multi_pod=mp, pricing=pricing, verbose=False)
    rec.pop("traceback", None)
    fn, args, _ = make_step(arch, shape, make_production_mesh(multi_pod=mp))
    outs = [t for t in tree_leaves(fn(*args)) if isinstance(t, torch.Tensor)]
    rec["output_global_bytes"] = sum(t.numel() * t.element_size() for t in outs)
    rec["output_count"] = len(outs)
    print("RECORD", json.dumps(rec), flush=True)
"""


def _records(code, pairs, timeout):
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code, json.dumps(pairs)],
                         capture_output=True, text=True, timeout=timeout, env=env)
    recs = [json.loads(ln[len("RECORD "):]) for ln in out.stdout.splitlines()
            if ln.startswith("RECORD ")]
    assert len(recs) == len(pairs), out.stdout[-3000:] + out.stderr[-3000:]
    return recs


def compare(pairs=PAIRS):
    """[(pair, reference record, port record)] for ``pairs``."""
    ref = _records(_REFERENCE, pairs, 600)
    port = _records(_PORT, pairs, 600)
    return list(zip(pairs, ref, port))


@pytest.fixture(scope="module")
def records():
    return {pair: (ref, port) for pair, ref, port in compare()}


def _ids(pair):
    return f"{pair[0]}-{pair[1]}-{'2x16x16' if pair[2] else '16x16'}"


def _kinds(census):
    return {k for k, v in census.items() if k != "total_bytes" and v["count"]}


@pytest.mark.parametrize("pair", PAIRS, ids=_ids)
def test_argument_bytes_equal_the_reference(records, pair):
    """The decode position is a 0-d int32 array in the reference and a host
    int in the port; ``jit`` drops it where the step never reads it
    (xLSTM has no rotary positions)."""
    ref, port = records[pair]
    assert ref["ok"] and port["ok"], (ref.get("error"), port.get("error"))
    assert port["mesh"] == ref["mesh"]
    reads_position = pair[1] != "prefill_32k" and pair[0] != "xlstm-350m"
    position = 4 if reads_position else 0
    assert port["memory"]["argument_bytes"] + position == ref["memory"]["argument_bytes"]


@pytest.mark.parametrize("pair", PAIRS, ids=_ids)
def test_output_bytes_against_the_reference(records, pair):
    """XLA's output figure is the outputs' global bytes, plus its tuple's
    table of 8-byte pointers where the step returns more than one array
    (the reference stacks its layers' caches, so it returns fewer arrays
    than the port's step has tensors); the port's is its local shards'."""
    ref, port = records[pair]
    extra = ref["memory"]["output_bytes"] - port["output_global_bytes"]
    assert extra % 8 == 0 and 0 <= extra <= 8 * port["output_count"], extra
    assert 0 < port["memory"]["output_bytes"] <= port["output_global_bytes"]


@pytest.mark.parametrize("pair", PAIRS, ids=_ids)
def test_collective_kinds_cover_the_reference(records, pair):
    ref, port = records[pair]
    assert _kinds(ref["collectives"]) <= _kinds(port["collectives"])


@pytest.mark.parametrize("pair", PAIRS, ids=_ids)
def test_collective_bytes_within_the_stated_factor(records, pair):
    """The reference's total over the port's, in the band of the pair's
    kind (the module docstring gives the causes; the bands are this
    repo's measured ratios widened about 2x either way):
      * prefill_32k (the batch split over 'data', both gather FSDP weights
        for the products): 1 to 4 (measured 1.65 on 16 x 16, 3.24 on
        2 x 16 x 16);
      * decode_32k (128 rows): XLA gathers each layer's whole K and V
        cache, in f32: at least B * W * KV * hd * 4 * 2 bytes; the rest
        over the port's total is 1 to 12 (measured 6.1, 6.2);
      * long_500k (one row, so the port leaves the products' partial sums
        on the split weights and all-reduces them, where XLA gathers the
        weights whole): 30 to 300 (measured 114 to 132)."""
    from repro_torch.configs import get_config
    ref, port = records[pair]
    ours, theirs = port["collectives"]["total_bytes"], ref["collectives"]["total_bytes"]
    if pair[1] == "prefill_32k":
        assert ours <= theirs <= 4 * ours
    elif pair[1] == "decode_32k":
        cfg = get_config(pair[0])
        whole = 128 * 32_768 * cfg.num_kv_heads * cfg.head_dim * 4 * 2
        assert ref["cache_gather_bytes"] >= whole
        assert ours <= theirs - ref["cache_gather_bytes"] <= 12 * ours
    else:
        assert 30 * ours <= theirs <= 300 * ours


@pytest.mark.parametrize("pair", PAIRS, ids=_ids)
def test_flops_per_device_within_the_stated_ratio(records, pair):
    """XLA's per-device FLOPs over the port's, in a band a pair's kind:
    XLA counts the layer loop's body once but runs it on whole weights (and
    on decode, whole caches) and counts elementwise ops, the port counts
    every layer's matrix products on the local shards. Bands are this
    repo's measured ratios widened about 2x either way: prefill 2 to 24
    (measured 5.4, 10.7), llama decode and long 40 to 350 (84 to 175),
    xlstm long 5 to 25 (11.5)."""
    ref, port = records[pair]
    ratio = ref["flops"] / port["flops_per_device"]
    lo, hi = {"prefill_32k": (2, 24)}.get(pair[1], (5, 25) if pair[0] == "xlstm-350m"
                                            else (40, 350))
    assert lo <= ratio <= hi, ratio


def main():
    print("| pair | mesh | argument B ref / port | output B ref / port | "
          "collective B ref / port (ref less cache gathers) | flops a device ref / port |")
    print("|---|---|---|---|---|---|")
    for (arch, shape, mp), r, p in compare():
        rc, pc = r["collectives"], p["collectives"]
        print(f"| {arch} x {shape} | {r['mesh']} | {r['memory']['argument_bytes']:,} / "
              f"{p['memory']['argument_bytes']:,} | {r['memory']['output_bytes']:,} / "
              f"{p['memory']['output_bytes']:,} | {rc['total_bytes']:,} / {pc['total_bytes']:,} "
              f"({rc['total_bytes'] - r['cache_gather_bytes']:,}) | {r['flops']:.4g} / "
              f"{p['flops_per_device']:.4g} |")


if __name__ == "__main__":
    main()
