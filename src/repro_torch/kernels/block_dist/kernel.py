"""CUDA kernel: per-block squared-L2 distance (SCAR priority scoring).

Replaces ``repro/kernels/block_dist/kernel.py::block_dist_pallas``. The
source, with its design note, is ``repro_torch/csrc/block_dist.cu``: a
chunked first pass over all SMs and a fixed-order second pass, so the
scores are the same on every run.

``block_dist_tree_cuda`` is the grouped form the main path runs: one call
for a whole tree, two launches (the passes), over the leaf table of
:mod:`repro_torch.kernels.leaf_table`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.leaf_table import (BLOCK_DIST_CHUNK, BlockDistTable,
                                             dist_pointers, upload)


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


def block_dist_tree_cuda(a_leaves: list, b_leaves: list,
                         table: BlockDistTable) -> torch.Tensor:
    """Per-block squared distances over two whole trees' leaves (flatten
    order, the leaf shapes of ``table``'s partition) -> (total_blocks,) f32;
    colocated leaves accumulate into their shared blocks.

    Leaves are read in place, contiguous f32 ones and pairs of contiguous
    bf16 ones (widened on the card); any other leaf is read from a
    contiguous f32 copy (the per-leaf route's ``.to(float32)``).
    The leaves' base addresses go to the card only when they differ from
    the last call's on this device."""
    if table.chunk != BLOCK_DIST_CHUNK:
        raise ValueError(f"a table of {table.chunk}-element chunks; the "
                         f"kernel's are {BLOCK_DIST_CHUNK}")
    device = a_leaves[0].device
    if device.type != "cuda":
        raise ValueError(f"block_dist_tree_cuda needs CUDA leaves, got "
                         f"{device}")
    ptrs, keep = dist_pointers(a_leaves, b_leaves, table)
    d = table.on(device)
    if ptrs != d.last:
        upload(ptrs, d.ptrs)
        d.last = ptrs
    total = table.total_blocks
    # one allocation: the scores, then the first pass's partials
    buf = torch.empty((total + table.n_items,), dtype=torch.float32,
                      device=device)
    _build.launch("block_dist", _build.library().block_dist_tree_f32, device,
                  d.geom, d.ptrs.data_ptr(), d.item_leaf, table.n_items,
                  d.seg_start, d.segs, buf.data_ptr() + 4 * total,
                  buf.data_ptr(), total)
    return buf[:total]
