"""CUDA kernel: in-place partial save of selected row-blocks.

Replaces ``repro/kernels/fused_maintain/kernel.py::scatter_save_pallas``.
The source, with its design note, is ``repro_torch/csrc/scatter_save.cu``.
The other kernels of the reference's ``fused_maintain`` package
(``fused_maintain_pallas``, ``arena_maintain_pallas``,
``arena_scatter_pallas``) are not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def scatter_save_cuda(dst: torch.Tensor, src: torch.Tensor,
                      rows: torch.Tensor, block_rows: int) -> torch.Tensor:
    """Copy block ``b`` (rows ``[b*block_rows, (b+1)*block_rows)``, the last
    block ragged) of ``src`` into ``dst`` for every id in ``rows``, in
    place. dst, src: (R, W) contiguous CUDA tensors of one dtype; rows:
    (k,) int32 on the same device, each in ``[0, ceil(R / block_rows))``.
    Returns ``dst``."""
    if dst.device.type != "cuda" or src.device != dst.device \
            or rows.device != dst.device:
        raise ValueError(f"scatter_save_cuda needs dst, src and rows on one "
                         f"CUDA device, got {dst.device}, {src.device}, "
                         f"{rows.device}")
    if src.dtype != dst.dtype:
        raise TypeError(f"dtypes differ: {dst.dtype} and {src.dtype}")
    if rows.dtype != torch.int32 or rows.dim() != 1:
        raise TypeError("rows must be a 1-D int32 tensor")
    if dst.dim() != 2 or dst.shape != src.shape:
        raise ValueError(f"need equal (R, W) shapes, got {tuple(dst.shape)} "
                         f"and {tuple(src.shape)}")
    if not (dst.is_contiguous() and src.is_contiguous()
            and rows.is_contiguous()):
        raise ValueError("scatter_save_cuda needs contiguous tensors")
    if block_rows < 1:
        raise ValueError("block_rows must be >= 1")
    r, w = dst.shape
    item = dst.element_size()
    block_bytes = block_rows * w * item
    total_bytes = r * w * item
    k = rows.shape[0]
    if k == 0 or total_bytes == 0:
        return dst
    if -(-block_bytes // _build.COPY_CHUNK_BYTES) > _build.MAX_GRID_Y:
        raise ValueError(f"block of {block_bytes} bytes is too large")
    _build.launch("scatter_save", _build.library().scatter_save_bytes,
                  dst.device, dst.data_ptr(), src.data_ptr(), rows.data_ptr(),
                  k, block_bytes, total_bytes)
    return dst
