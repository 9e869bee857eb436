"""Dry-run: plan every (architecture x input shape) pair on the 16 x 16
single-pod mesh and the 2 x 16 x 16 multi-pod mesh, allocating nothing (the
reference's ``repro.launch.dryrun``).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape long_500k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod | --both-meshes] [--out FILE]

The reference lowers and compiles each pair on a host platform that fakes
512 devices and reads XLA's memory and cost analyses. The port has no
partitioner; for each pair it records instead
  * ``memory.argument_bytes``: one device's bytes of the step's arguments
    (params, AdamW state, decode state, batch), summed over the local shards
    that DTensor gives each meta argument under its placements
    (``sharding.to_placements``) on a ``DeviceMesh`` over a fake process
    group (``launch.mesh``);
  * ``flops``: the whole step's floating-point operations, counted by
    ``torch.utils.flop_counter.FlopCounterMode`` while the step runs on its
    meta arguments (shapes only, nothing computed or allocated; a trace
    under ``FakeTensorMode`` counts the same and took 3x as long). It counts
    the global step on every device together, where XLA's
    ``cost_analysis`` counts one device's share (``flops_scope``). Only
    matrix products count; attention runs its plain version on meta
    tensors and counts its whole score matrix, masked entries included; a
    train pair adds the backward and remat's recompute of the forward.
    For llama3.2-1b the prefill and decode counts equal the analytic count
    (tests/test_torch_distributed.py); nothing holds the train count to one;
  * ``collectives: null``: the reference's census of collective bytes parses
    the HLO of a partitioned program, and the port emits none.
It runs on the CPU and touches no card. A pair that fails is a record with
``ok: false`` and its error; the exit code is 1 unless every pair is ok.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback

import torch

from repro_torch.configs import ASSIGNED_ARCHS, SHAPES
from repro_torch.distributed.sharding import is_spec, to_placements
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import make_step
from repro_torch.tree import tree_leaves

FLOPS_SCOPE = ("global: the whole step on every device together (FlopCounterMode over a "
               "run on meta tensors), where XLA's cost_analysis counts one device's share; "
               "matrix products only, attention over its whole score matrix (masked "
               "entries included), a train step with its backward and remat's recompute")


def argument_bytes(args, specs, mesh) -> int:
    """One device's bytes of ``args``: each tensor leaf distributed over
    ``mesh`` by its spec, its local shard's numel times its element size
    (meta tensors: nothing is allocated). Host values count nothing."""
    from torch.distributed.tensor import distribute_tensor
    total = 0
    for leaf, spec in zip(tree_leaves(args), tree_leaves(specs, is_spec)):
        if isinstance(leaf, torch.Tensor):
            local = distribute_tensor(leaf, mesh, to_placements(spec, mesh)).to_local()
            total += local.numel() * local.element_size()
    return total


def step_flops(fn, args) -> int:
    """The operations of ``fn(*args)`` run on the meta arguments as they are
    (shapes only; the kernel wrappers run their plain versions on meta
    tensors)."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return counter.get_total_flops()


def mesh_name(mesh) -> str:
    return "x".join(str(s) for s in mesh.mesh.shape)


def dryrun_pair(arch: str, shape: str, *, multi_pod: bool = False, mesh=None,
                verbose: bool = True, **overrides) -> dict:
    """One pair's record: ``arch``, ``shape``, ``mesh``, ``ok``, ``error``,
    and when ok ``memory.argument_bytes``, ``flops`` (with
    ``flops_scope``), ``collectives`` (None) and the seconds taken. ``mesh``
    (default: the production mesh ``multi_pod`` names) and ``overrides``
    (``make_step``'s keywords) pick the plan."""
    mesh = make_production_mesh(multi_pod=multi_pod) if mesh is None else mesh
    rec = {"arch": arch, "shape": shape, "mesh": mesh_name(mesh), "ok": False,
           "error": None}
    t0 = time.perf_counter()
    try:
        fn, args, specs = make_step(arch, shape, mesh, **overrides)
        nbytes = argument_bytes(args, specs, mesh)
        t_plan = time.perf_counter() - t0
        flops = step_flops(fn, args)
        rec.update(ok=True, plan_s=round(t_plan, 2),
                   trace_s=round(time.perf_counter() - t0 - t_plan, 2),
                   flops=flops, flops_scope=FLOPS_SCOPE, collectives=None,
                   memory={"argument_bytes": nbytes})
        if verbose:
            print(f"[OK] {arch} x {shape} ({rec['mesh']}) plan {t_plan:.1f}s trace "
                  f"{rec['trace_s']:.1f}s flops {flops:.3g} (global) argument bytes "
                  f"{nbytes:.4g} per device")
    except Exception as e:  # noqa: BLE001 — a dry-run failure is a finding, not a crash
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        if verbose:
            print(f"[FAIL] {arch} x {shape} ({rec['mesh']}): {rec['error']}")
    rec["seconds"] = round(time.perf_counter() - t0, 2)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    archs = ASSIGNED_ARCHS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    results = [dryrun_pair(a, s, multi_pod=mp) for mp in meshes for a in archs
               for s in shapes]
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    n_ok = sum(r["ok"] for r in results)
    print(f"\n{n_ok}/{len(results)} pairs planned")
    return 0 if n_ok == len(results) else 1


if __name__ == "__main__":
    sys.exit(main())
