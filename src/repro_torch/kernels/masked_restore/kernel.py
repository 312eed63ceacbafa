"""CUDA kernel: masked block restore (SCAR partial recovery).

Replaces ``repro/kernels/masked_restore/kernel.py::masked_restore_pallas``.
The source, with its design note, is
``repro_torch/csrc/masked_restore.cu``: each CTA reads its block's mask
bit first and loads only the side the block needs.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def masked_restore_cuda(dst: torch.Tensor, src: torch.Tensor,
                        mask: torch.Tensor,
                        block_rows: int = 1) -> torch.Tensor:
    """Block ``b`` (rows ``[b*block_rows, (b+1)*block_rows)``, the last
    block ragged) of the output is ``src``'s where ``mask[b]``, else
    ``dst``'s. dst, src: (R, W) contiguous CUDA tensors of one dtype; mask:
    (ceil(R / block_rows),) bool on the same device. ``block_rows=1`` is the
    reference's (n_blocks, E) form. Returns a new (R, W) tensor."""
    if dst.device.type != "cuda" or src.device != dst.device \
            or mask.device != dst.device:
        raise ValueError(f"masked_restore_cuda needs dst, src and mask on "
                         f"one CUDA device, got {dst.device}, {src.device}, "
                         f"{mask.device}")
    if src.dtype != dst.dtype:
        raise TypeError(f"dtypes differ: {dst.dtype} and {src.dtype}")
    if mask.dtype != torch.bool:
        raise TypeError(f"mask must be bool, got {mask.dtype}")
    if block_rows < 1:
        raise ValueError("block_rows must be >= 1")
    if dst.dim() != 2 or dst.shape != src.shape \
            or mask.shape != (max(1, -(-dst.shape[0] // block_rows)),):
        raise ValueError(f"need (R, W) dst/src and (ceil(R / block_rows),) "
                         f"mask, got {tuple(dst.shape)}, {tuple(src.shape)}, "
                         f"{tuple(mask.shape)} with block_rows {block_rows}")
    if not (dst.is_contiguous() and src.is_contiguous()
            and mask.is_contiguous()):
        raise ValueError("masked_restore_cuda needs contiguous tensors")
    r, w = dst.shape
    out = torch.empty_like(dst)
    item = dst.element_size()
    block_bytes = block_rows * w * item
    total_bytes = r * w * item
    if total_bytes == 0:
        return out
    if -(-block_bytes // _build.COPY_CHUNK_BYTES) > _build.MAX_GRID_Y:
        raise ValueError(f"block of {block_bytes} bytes is too large")
    _build.launch("masked_restore", _build.library().masked_restore_bytes,
                  dst.device, dst.data_ptr(), src.data_ptr(), mask.data_ptr(),
                  out.data_ptr(), block_bytes, total_bytes)
    return out
