"""CUDA kernel: per-block squared-L2 distance (SCAR priority scoring).

Replaces ``repro/kernels/block_dist/kernel.py::block_dist_pallas``. The
source, with its design note, is ``repro_torch/csrc/block_dist.cu``: a
chunked first pass over all SMs and a fixed-order second pass, so the
scores are the same on every run.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def block_dist_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b: (n_blocks, E) f32 contiguous CUDA tensors -> (n_blocks,) f32."""
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"block_dist_cuda needs two tensors on one CUDA "
                         f"device, got {a.device} and {b.device}")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"block_dist_cuda takes float32, got {a.dtype}, "
                        f"{b.dtype}")
    if a.dim() != 2 or a.shape != b.shape:
        raise ValueError(f"need equal (n_blocks, E) shapes, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("block_dist_cuda needs contiguous inputs")
    n, e = a.shape
    if n == 0 or e == 0:
        return torch.zeros((n,), dtype=torch.float32, device=a.device)
    lib = _build.library()
    chunks = lib.block_dist_chunks(e)
    if chunks > _build.MAX_GRID_Y:
        raise ValueError(f"block of {e} elements exceeds the kernel's "
                         f"{_build.MAX_GRID_Y} chunks")
    # one allocation: the n scores, then the first pass's n * chunks partials
    buf = torch.empty((n * (chunks + 1),), dtype=torch.float32,
                      device=a.device)
    _build.launch("block_dist", lib.block_dist_f32, a.device, a.data_ptr(),
                  b.data_ptr(), buf.data_ptr() + 4 * n, buf.data_ptr(), n, e)
    return buf[:n]
