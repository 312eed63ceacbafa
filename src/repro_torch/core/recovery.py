"""Failure injection + recovery (paper §4.1, Theorems 4.1/4.2).

The port of ``repro.core.recovery``. A failure destroys a subset of
parameter blocks. Recovery replaces state from the running checkpoint:

- FULL    -- traditional: all parameters reset to the checkpoint. The
             perturbation is δ = z − x^{(T)} over the whole tree.
- PARTIAL -- SCAR: only the lost blocks are restored; survivors keep their
             newer values. The perturbation is δ' = (z − x^{(T)}) restricted
             to the lost blocks, and ||δ'|| ≤ ||δ|| (Thm 4.1). On CUDA the
             restore is the masked_restore kernel (through
             :func:`repro_torch.core.blocks.select_blocks`).

Failure masks are sampled uniformly over blocks with a CPU
``torch.Generator``, so a run draws the same mask on every device.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.blocks import (BlockPartition, masked_total,
                                     random_blocks, select_blocks)
from repro_torch.core.checkpoint import RunningCheckpoint, clone_tree
from repro_torch.core.policy import RecoveryMode
from repro_torch.kernels.block_dist.ops import tree_block_scores

PyTree = Any


def sample_failure_mask(rng: torch.Generator, partition: BlockPartition,
                        fraction: float,
                        device: torch.device | str = "cpu") -> torch.Tensor:
    """Lose a fraction ``p`` of blocks chosen uniformly at random (Thm 4.2)."""
    total = partition.total_blocks
    k = max(1, round(fraction * total))
    idx = random_blocks(rng, total, min(k, total))
    mask = torch.zeros((total,), dtype=torch.bool)
    mask[idx] = True
    return mask.to(device)


def recover(params: PyTree, ckpt: RunningCheckpoint, lost_mask: torch.Tensor,
            mode: RecoveryMode, partition: BlockPartition) -> PyTree:
    """Apply checkpoint recovery after ``lost_mask`` blocks were destroyed."""
    if mode == RecoveryMode.FULL:
        return clone_tree(ckpt.values)
    return select_blocks(params, ckpt.values, lost_mask, partition)


def perturbation_norms(params: PyTree, ckpt: RunningCheckpoint,
                       lost_mask: torch.Tensor, partition: BlockPartition,
                       ) -> dict[str, torch.Tensor]:
    """||δ||² (full recovery) and ||δ'||² (partial) for this failure: the
    sum and the masked sum of one pass of per-block distances (one grouped
    block_dist call on the card)."""
    per_block = tree_block_scores(ckpt.values, params, partition)
    return {"full_sq": per_block.sum(),
            "partial_sq": masked_total(per_block, lost_mask)}


def apply_failure_and_recover(params: PyTree, ckpt: RunningCheckpoint,
                              lost_mask: torch.Tensor, mode: RecoveryMode,
                              partition: BlockPartition,
                              ) -> tuple[PyTree, dict[str, torch.Tensor]]:
    """Simulate the failure + recovery transition in one step.

    Returns the post-recovery params and the perturbation diagnostics.
    """
    info = perturbation_norms(params, ckpt, lost_mask, partition)
    recovered = recover(params, ckpt, lost_mask, mode, partition)
    info["applied_sq"] = tree_block_scores(recovered, params,
                                           partition).sum()
    info["lost_blocks"] = torch.sum(lost_mask.to(torch.int64))
    return recovered, info
