"""Tree-level priority scoring backed by the block_dist kernel.

:func:`tree_block_dist` is the whole-tree form: one grouped kernel call on
CUDA leaves, the plain version per leaf on CPU leaves. The l2 norm
carries it (``core/norms.py``), so ``block_scores`` under l2, and so
``tree_block_scores``, ``make_score_fn`` and ``masked_sq_norm``, make one
grouped call per tree on the card. Scores of colocated leaves accumulate
into their shared block ids, as ``block_scores`` does.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Any

import torch

from repro_torch.kernels.block_dist.kernel import (block_dist_cuda,
                                                   block_dist_tree_cuda)
from repro_torch.kernels.block_dist.ref import (block_dist_ref,
                                                block_dist_tree_ref)
from repro_torch.kernels.leaf_table import block_dist_table
from repro_torch.utils.tree import tree_leaves

if TYPE_CHECKING:   # core.blocks imports this module (masked_sq_norm)
    from repro_torch.core.blocks import BlockPartition

PyTree = Any


def block_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(n_blocks, E) pair -> (n_blocks,) squared distances: the plain
    version for CPU tensors, the CUDA kernel otherwise."""
    if a.device.type == "cpu":
        return block_dist_ref(a, b)
    return block_dist_cuda(a.to(torch.float32).contiguous(),
                           b.to(torch.float32).contiguous())


def tree_block_dist(a_leaves: list, b_leaves: list,
                    partition: BlockPartition) -> torch.Tensor:
    """Per-block squared distances between two trees' leaves (flatten
    order) -> (total_blocks,) f32: the plain version per leaf for CPU
    leaves, one grouped kernel call otherwise."""
    if a_leaves[0].device.type == "cpu":
        return block_dist_tree_ref(a_leaves, b_leaves, partition)
    return block_dist_tree_cuda(a_leaves, b_leaves,
                                block_dist_table(partition))


def tree_block_scores(params: PyTree, ckpt_values: PyTree,
                      partition: BlockPartition) -> torch.Tensor:
    """Per-block squared distances over a whole tree -> (total_blocks,):
    ``block_scores`` under the l2 norm."""
    return tree_block_dist(tree_leaves(params), tree_leaves(ckpt_values),
                           partition)


def make_score_fn(partition: BlockPartition):
    """score_fn for FTController(score_fn=...): kernel-backed priority."""
    def score(params, ckpt_values):
        return tree_block_scores(params, ckpt_values, partition)
    return score
