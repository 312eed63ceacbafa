"""Tree-level partial restore backed by the masked_restore kernel.

``tree_masked_restore`` is :func:`repro_torch.core.blocks.select_blocks`
(dst = live params, src = checkpoint, mask = lost blocks for PARTIAL
recovery; dst = checkpoint, src = params, mask = saved blocks for the
``inplace_save=False`` save): one grouped kernel launch for the whole tree
on CUDA leaves, each leaf's raw (R, W) rows unpadded; the plain version
leaf by leaf on CPU leaves. ``arena_masked_restore`` is the same restore
with a flat arena as source. ``masked_restore`` is one leaf's select.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.blocks import BlockPartition
from repro_torch.kernels.masked_restore.kernel import (
    masked_restore_cuda, masked_restore_tree_cuda)
from repro_torch.kernels.masked_restore.ref import (masked_restore_ref,
                                                    tree_masked_restore_ref)
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
    (:mod:`repro_torch.core.arena`): the touched leaves in one grouped
    launch on the card; untouched leaves pass through as the same tensors.
    The tier planner's PEER_REPLICA restore from an arena-form replica."""
    from repro_torch.core.arena import arena_restore
    return arena_restore(dst, src_arena, global_mask, arena_layout)


def tree_masked_restore(dst: PyTree, src: PyTree, global_mask: torch.Tensor,
                        partition: BlockPartition) -> PyTree:
    """Per block: ``src``'s block where the mask is set, else ``dst``'s.
    Returns a new tree (on the card, its leaves are views of one buffer)."""
    dst_flat, treedef = tree_flatten(dst)
    device = dst_flat[0].device
    if device.type == "cpu":
        return tree_masked_restore_ref(dst, src, global_mask, partition)
    mask = global_mask.to(device=device, dtype=torch.bool).contiguous()
    return tree_unflatten(treedef, masked_restore_tree_cuda(
        dst_flat, tree_leaves(src), mask, partition))
