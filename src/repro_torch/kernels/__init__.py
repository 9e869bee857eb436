"""Hand-written CUDA kernels for Hopper (``csrc/*.cu``, sm_90a), one module each.

Each module holds the kernel's wrapper, its plain PyTorch version (what the
wrapper runs on CPU tensors) and a ``launches`` counter. ``_build`` compiles
the sources with nvcc at first use and loads them with ctypes.
"""
