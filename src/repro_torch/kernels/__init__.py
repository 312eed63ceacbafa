"""Hand-written CUDA kernels of the port, one package per TPU kernel.

Each package keeps the reference's split: ``kernel.py`` launches the CUDA
kernel (built from ``repro_torch/csrc/`` by :mod:`._build`), ``ref.py``
holds the plain PyTorch version of the same function, and ``ops.py``
picks between them by the device of the tensors it is given: the plain
version for CPU tensors, the kernel for CUDA tensors. There is no
fallback from the kernel to the plain version.
"""
