"""CUDA kernel: masked block restore (SCAR partial recovery).

Replaces ``repro/kernels/masked_restore/kernel.py::masked_restore_pallas``.
The source, with its design note, is
``repro_torch/csrc/masked_restore.cu``: each CTA reads its block's mask
bit first and loads only the side the block needs.

``masked_restore_tree_cuda`` is the grouped form the main paths run: one
launch for a whole tree, over the leaf table of
:mod:`repro_torch.kernels.leaf_table`. ``masked_restore_cuda`` is one
leaf's launch.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Optional

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.leaf_table import restore_call, restore_table, upload

if TYPE_CHECKING:   # core.blocks imports the block_dist ops, and so this
    from repro_torch.core.blocks import BlockPartition


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


def masked_restore_tree_cuda(dst_leaves: list, src_leaves: list,
                             mask: torch.Tensor, partition: BlockPartition,
                             touched: Optional[np.ndarray] = None) -> list:
    """Per block of every leaf (flatten order, ``partition``'s leaves; only
    the leaves ``touched`` when given): ``src``'s bytes where ``mask`` is
    set, else ``dst``'s, into new tensors, in one launch. ``mask``:
    (total_blocks,) bool on the leaves' CUDA device. A source is a tensor
    or an ``(address, pitch)`` pair read in place, as
    :func:`~repro_torch.kernels.leaf_table.restore_call` takes it. Returns
    the output leaves (None for a leaf left out): views of one buffer.
    The pointer column goes to the card only when it differs from the last
    call's on this device and stream."""
    idx = range(len(dst_leaves)) if touched is None else touched
    if not len(idx):
        return [None] * len(dst_leaves)
    device = dst_leaves[int(idx[0])].device
    if device.type != "cuda":
        raise ValueError(f"masked_restore_tree_cuda needs CUDA leaves, got "
                         f"{device}")
    table = restore_table(partition, tuple(d.dtype for d in dst_leaves))
    if mask.device != device or mask.dtype != torch.bool \
            or mask.shape != (table.total_blocks,) or not mask.is_contiguous():
        raise ValueError(f"need a contiguous ({table.total_blocks},) bool "
                         f"mask on {device}, got {tuple(mask.shape)} "
                         f"{mask.dtype} on {mask.device}")
    call = restore_call(dst_leaves, src_leaves, table, touched)
    d = table.on(device)
    if call.column != d.last:
        upload(call.column, d.ptrs)
        d.last = call.column
    if table.n_items:
        _build.launch("masked_restore",
                      _build.library().masked_restore_tree_bytes, device,
                      d.geom, d.ptrs.data_ptr(), d.item_leaf, table.n_items,
                      mask.data_ptr())
    return call.out
