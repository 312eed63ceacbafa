"""Tree-level priority scoring backed by the block_dist kernel.

``tree_block_scores`` is the drop-in for
:func:`repro_torch.core.blocks.block_scores` under the l2 norm, wired
into ``FTController(score_fn=...)`` by :func:`make_score_fn`. Scores of
colocated leaves accumulate into their shared block ids, as
``block_scores`` does.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.blocks import BlockPartition, block_scores
from repro_torch.kernels.block_dist.kernel import block_dist_cuda
from repro_torch.kernels.block_dist.ref import block_dist_ref

PyTree = Any


def block_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(n_blocks, E) pair -> (n_blocks,) squared distances: the plain
    version for CPU tensors, the CUDA kernel otherwise."""
    if a.device.type == "cpu":
        return block_dist_ref(a, b)
    return block_dist_cuda(a.to(torch.float32).contiguous(),
                           b.to(torch.float32).contiguous())


def tree_block_scores(params: PyTree, ckpt_values: PyTree,
                      partition: BlockPartition) -> torch.Tensor:
    """Per-block squared distances over a whole tree -> (total_blocks,):
    ``block_scores`` under the l2 norm, which is this kernel."""
    from repro_torch.core.norms import get_norm
    return block_scores(params, ckpt_values, partition, get_norm("l2"))


def make_score_fn(partition: BlockPartition):
    """score_fn for FTController(score_fn=...): kernel-backed priority."""
    def score(params, ckpt_values):
        return tree_block_scores(params, ckpt_values, partition)
    return score
