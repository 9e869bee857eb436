"""Meshes for the dry-run's placement plans.

The reference lowers its steps on a host platform that fakes 512 devices.
The port's counterpart is a ``DeviceMesh`` over a fake process group
(``torch.testing._internal.distributed.fake_pg``): every collective is a
no-op and no device is touched, so DTensor computes each rank's local shard
shapes for a pod that does not exist. The group is global to the process,
as ``torch.distributed`` groups are: :func:`fake_world` creates it on first
use with :data:`WORLD` ranks, this process being rank 0, and every mesh here
takes the first ranks of it (16 x 16 the first 256, 2 x 16 x 16 all 512,
the local mesh rank 0 alone), so one process can plan on every mesh.
Functions, not module-level constants: importing this module creates no
group.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

WORLD = 512        # the multi-pod mesh's device count


def fake_world() -> None:
    """Create the fake process group of :data:`WORLD` ranks, unless this
    process already has it; any other default group is an error."""
    if dist.is_initialized():
        if dist.get_backend() != "fake" or dist.get_world_size() != WORLD:
            raise RuntimeError(
                f"a process group ({dist.get_backend()}, {dist.get_world_size()} ranks) "
                f"is already initialized; the dry-run plans over its own fake group of "
                f"{WORLD} ranks, so run it in a process of its own")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", world_size=WORLD, rank=0, store=FakeStore())


def _mesh(device_type: str, shape: tuple, names: tuple) -> DeviceMesh:
    fake_world()
    n = 1
    for s in shape:
        n *= s
    return DeviceMesh(device_type, torch.arange(n).reshape(shape), mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """16 x 16 = 256 chips per pod (``data, model``); 2 pods = 512 chips with
    a leading 'pod' axis."""
    if multi_pod:
        return _mesh("cpu", (2, 16, 16), ("pod", "data", "model"))
    return _mesh("cpu", (16, 16), ("data", "model"))


def make_local_mesh(device="cpu") -> DeviceMesh:
    """This process's device as a degenerate 1 x 1 ``(data, model)`` mesh:
    every spec replicates, so a tensor's local shard is the whole of it."""
    return _mesh(torch.device(device).type, (1, 1), ("data", "model"))
