"""Tree-level partial restore backed by the masked_restore kernel.

``tree_masked_restore`` is :func:`repro_torch.core.blocks.select_blocks`
(dst = live params, src = checkpoint, mask = lost blocks for PARTIAL
recovery; dst = checkpoint, src = params, mask = saved blocks for the
``inplace_save=False`` save). Each leaf goes to the kernel as its raw
(R, W) row matrix, unpadded, as ``tree_scatter_save`` does.
``arena_masked_restore`` is the same restore with a flat arena as source.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.blocks import BlockPartition, split_global_mask
from repro_torch.kernels.masked_restore.kernel import masked_restore_cuda
from repro_torch.kernels.masked_restore.ref import masked_restore_ref
from repro_torch.utils.tree import tree_flatten, tree_leaves, tree_unflatten

PyTree = Any


def masked_restore(dst: torch.Tensor, src: torch.Tensor, mask: torch.Tensor,
                   block_rows: int = 1) -> torch.Tensor:
    """(R, W) select by block of ``block_rows`` rows: the plain version for
    CPU tensors, the CUDA kernel otherwise."""
    if dst.device.type == "cpu":
        return masked_restore_ref(dst, src, mask, block_rows)
    return masked_restore_cuda(dst.contiguous(), src.contiguous(),
                               mask.contiguous(), block_rows)


def arena_masked_restore(dst: PyTree, src_arena: torch.Tensor, global_mask,
                         arena_layout) -> PyTree:
    """Partial restore whose source is a flat arena
    (:mod:`repro_torch.core.arena`): each touched leaf decodes one
    contiguous arena slice and goes through :func:`masked_restore`;
    untouched leaves pass through as the same tensors. The tier planner's
    PEER_REPLICA restore from an arena-form replica."""
    from repro_torch.core.arena import arena_restore
    return arena_restore(dst, src_arena, global_mask, arena_layout)


def tree_masked_restore(dst: PyTree, src: PyTree, global_mask: torch.Tensor,
                        partition: BlockPartition) -> PyTree:
    """Per block: ``src``'s block where the mask is set, else ``dst``'s.
    Returns a new tree."""
    dst_flat, treedef = tree_flatten(dst)
    src_flat = tree_leaves(src)
    masks = split_global_mask(global_mask.to(torch.bool), partition)
    out = []
    for d, s, m, leaf in zip(dst_flat, src_flat, masks, partition.leaves):
        shape2d = (leaf.rows, leaf.row_width)
        r = masked_restore(d.reshape(shape2d),
                           s.to(d.dtype).reshape(shape2d), m,
                           partition.block_rows)
        out.append(r.reshape(leaf.shape))
    return tree_unflatten(treedef, out)
