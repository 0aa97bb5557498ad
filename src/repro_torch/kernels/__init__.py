"""Hand-written CUDA kernels of the port, one package per TPU kernel.

Each package holds ``<name>.py`` (the ctypes wrapper and its launch
count), ``ref.py`` (the plain PyTorch version) and ``ops.py`` (the public
op: the plain version for CPU tensors, the kernel for CUDA tensors).
The sources are in ``repro_torch/csrc``; ``_build`` compiles them.
"""
