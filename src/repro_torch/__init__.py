"""PyTorch + CUDA port of the RaLMSpec serving system.

The JAX package ``repro`` is the reference; this package mirrors its layout
(``configs``, ``models``, ``kernels``, ``retrieval``, ``core``, ``serving``,
``training``, ``distributed``, ``launch``) and imports nothing of it. The kernels on the main
path are CUDA C++ for Hopper (``kernels/csrc``), each with a plain PyTorch
version beside it that runs when the tensors lie on the CPU.

The reference's numeric contracts are IEEE fp32, so TF32 is switched off for
matrix products and convolutions as soon as the package is imported.
"""
from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks for
    another one. Asking for CUDA where there is none raises; nothing falls
    back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default, and "
            "torch.cuda.is_available() is False here; pass device='cpu' "
            "(CLI: --device cpu) to run the plain PyTorch versions on the CPU")
    return dev
