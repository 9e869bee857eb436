"""Build and load the CUDA sources under ``csrc/``.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library with
a plain C interface, loaded with ``ctypes``. Libraries go to ``build/kernels/``
at the root of the checkout, named by a hash of the source and the flags, so an
edited source is rebuilt and an unchanged one is reused. :func:`build_all`
starts one ``nvcc`` per source, all at once; :func:`library` builds (or loads)
one on first use. Nothing here runs when the module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("dense_topk", "gathered_topk", "decode_attention", "prefill_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are built from source at first use")
    return found


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Launch nvcc for one source unless its library is already built.
    Returns (target, process or None)."""
    out = _target(name)
    if out.exists():
        return out, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, (proc, tmp)


def _finish(name: str, out: Path, job) -> str:
    if job is None:
        return ""
    proc, tmp = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)                 # atomic: concurrent builds agree
    return log


def _load(name: str, out: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(out))
    _libs[name] = lib
    return lib


def build_all() -> Dict[str, str]:
    """Build every source in parallel (one nvcc each) and load them all.
    Returns each source's compiler log (ptxas register and shared-memory
    report; empty when the library was already built)."""
    with _lock:
        jobs = {n: _start(n) for n in SOURCES if n not in _libs}
        logs = {}
        for n, (out, job) in jobs.items():
            logs[n] = _finish(n, out, job)
            _load(n, out)
        return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            out, job = _start(name)
            _finish(name, out, job)
            _load(name, out)
        return _libs[name]


def check(rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error (its cudaGetLastError)."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def on_cpu(what: str, *tensors) -> bool:
    """Dispatch rule shared by every wrapper: True when all inputs lie on the
    CPU (run the plain version), or on the meta device (the plain version
    computes shapes only: the dry-run's trace, ``launch.dryrun``); False
    when all lie on one CUDA device (launch the kernel). Anything else
    raises."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"{what}: inputs on several devices {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type in ("cpu", "meta"):
        return True
    if dev.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {dev}")
    return False


def refuse_grad(what: str, *tensors) -> None:
    """The attention kernels have no backward: a ctypes launch writes its
    output into a tensor autograd knows nothing of, so a training pass
    through one would lose every gradient behind it without an error. Raise
    when grad mode is on and an input requires grad, on the CPU too, so that
    a CPU test catches a training route that reaches a wrapper."""
    import torch
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what}: the kernel has no backward and its inputs require grad; "
            "train through the differentiable route (models.layers."
            "apply_self_attention, Model.forward(differentiable=True)), or run "
            "the kernel under torch.no_grad()")


def check_kernel_inputs(what: str, dtype, *tensors) -> None:
    """The CUDA entry points take contiguous, 16-byte aligned tensors of one
    dtype; raise on anything else rather than launching on it."""
    for t in tensors:
        if t.dtype != dtype:
            raise TypeError(f"{what}: expected {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: the kernel takes contiguous tensors")
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: tensor data is not 16-byte aligned")


def stream_ptr(device) -> int:
    """The raw handle of PyTorch's current stream on ``device`` (a CUDA
    tensor's device, so its index is set): the stream a launch is enqueued
    on, the capturing one during CUDA-graph capture. Read without building a
    ``torch.cuda.Stream`` object, which costs microseconds per launch."""
    import torch
    return torch._C._cuda_getCurrentRawStream(device.index)
