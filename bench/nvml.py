"""The card's own count of the time in which a kernel ran, read through
NVML (``libnvidia-ml``, the library ``nvidia-smi`` reads) while the window
runs: the driver's utilization counter, the share of each sample period
(1/6 to 1 s) in which one or more kernels executed on the card, polled from
a thread every ``PERIOD`` seconds and averaged. It counts device time only,
so the host's speed, which moves the window's wall time, does not move it.
"""
from __future__ import annotations

import ctypes
import threading

PERIOD = 0.01     # seconds between two reads


class _Util(ctypes.Structure):
    _fields_ = [("gpu", ctypes.c_uint), ("memory", ctypes.c_uint)]


def _handle(index: int):
    """-> (the NVML library, the card's handle), or None where NVML is absent."""
    try:
        lib = ctypes.CDLL("libnvidia-ml.so.1")
    except OSError:
        return None
    h = ctypes.c_void_p()
    if lib.nvmlInit_v2() != 0 or lib.nvmlDeviceGetHandleByIndex_v2(index, ctypes.byref(h)) != 0:
        return None
    return lib, h


def nvml_index(device) -> int:
    """NVML's index of a torch CUDA device (they differ under
    ``CUDA_VISIBLE_DEVICES``)."""
    import torch
    try:
        return int(torch.cuda._get_nvml_device_index(device))
    except Exception:
        return int(torch.device(device).index or 0)


class BusyMeter:
    """``start()`` ... ``stop()`` -> the mean share of time in which a kernel
    ran on the card, in [0, 1], or None where NVML cannot be read."""

    def __init__(self, index: int):
        self._nvml = _handle(index)
        self._reads: list = []
        self._stop = threading.Event()
        self._thread = None

    def _poll(self) -> None:
        lib, h = self._nvml
        u = _Util()
        while not self._stop.is_set():
            if lib.nvmlDeviceGetUtilizationRates(h, ctypes.byref(u)) == 0:
                self._reads.append(u.gpu)
            self._stop.wait(PERIOD)

    def start(self) -> None:
        if self._nvml is not None:
            self._thread = threading.Thread(target=self._poll, name="nvml-busy", daemon=True)
            self._thread.start()

    def stop(self):
        if self._thread is None:
            return None
        self._stop.set()
        self._thread.join()
        self._thread = None
        return sum(self._reads) / (100.0 * len(self._reads)) if self._reads else None
