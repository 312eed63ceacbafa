"""Running checkpoint + selection strategies (paper §4.2, §4.3).

The port of ``repro.core.checkpoint``. The running checkpoint lives in
device memory, starts as ``x^{(0)}`` and is updated by partial
checkpoints, so at any time it holds a mix of parameters saved at
different iterations.

``save_step`` returns a new checkpoint whose values come from
:func:`repro_torch.core.blocks.select_blocks` (the
``FTController(inplace_save=False)`` path). The controller's default save
selects with :func:`select_save_mask` and then copies only the selected
blocks in place (:func:`repro_torch.kernels.fused_maintain.ops.tree_scatter_save`).

Selection strategies:

- PRIORITY     -- top-k blocks by distance since the last save.
- ROUND_ROBIN  -- k blocks at a rotating cursor.
- RANDOM       -- k blocks uniformly at random (``torch.Generator``).

Top-k is a stable descending sort, so blocks whose scores tie at the k-th
place go to the lower id, as ``jax.lax.top_k`` does; ``torch.topk`` may
pick another set.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.core.blocks import (BlockPartition, block_scores,
                                     random_blocks, select_blocks)
from repro_torch.core.norms import NormFn
from repro_torch.core.policy import CheckpointPolicy, SelectionStrategy
from repro_torch.utils.tree import tree_leaves, tree_map

PyTree = Any


@dataclasses.dataclass
class RunningCheckpoint:
    values: PyTree              # same structure/shapes as params
    saved_iter: torch.Tensor    # (total_blocks,) int32 -- iter each block was saved
    rr_cursor: torch.Tensor     # () int32 -- round-robin cursor


def clone_tree(tree: PyTree) -> PyTree:
    """Contiguous copies of every leaf (in-place saves need contiguity)."""
    return tree_map(
        lambda x: x.detach().clone(memory_format=torch.contiguous_format),
        tree)


def init_running_checkpoint(params: PyTree,
                            partition: BlockPartition) -> RunningCheckpoint:
    """Paper §4.2: the running checkpoint starts as x^{(0)}."""
    values = clone_tree(params)
    device = tree_leaves(values)[0].device
    return RunningCheckpoint(
        values=values,
        saved_iter=torch.zeros((partition.total_blocks,), dtype=torch.int32,
                               device=device),
        rr_cursor=torch.zeros((), dtype=torch.int32, device=device),
    )


def top_k_indices(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest scores, ties to the lower index (as
    ``jax.lax.top_k``)."""
    return torch.sort(scores, descending=True, stable=True).indices[:k]


def _mask_from_indices(idx: torch.Tensor, total: int,
                       device: torch.device) -> torch.Tensor:
    mask = torch.zeros((total,), dtype=torch.bool, device=device)
    mask[idx.to(device)] = True
    return mask


def select_save_mask(ckpt: RunningCheckpoint, params: PyTree, *,
                     policy: CheckpointPolicy, partition: BlockPartition,
                     norm_fn: NormFn, rng: Optional[torch.Generator] = None,
                     scores: Optional[torch.Tensor] = None,
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Choose which blocks to save. Returns (mask, new_rr_cursor).

    ``scores`` may be precomputed (e.g. by a ``score_fn``); otherwise they
    are computed with ``norm_fn`` for the PRIORITY strategy. ``rng`` (a CPU
    generator) draws the RANDOM strategy's blocks.
    """
    total = partition.total_blocks
    k = partition.blocks_for_k(policy.fraction)
    device = ckpt.saved_iter.device
    if policy.strategy == SelectionStrategy.PRIORITY:
        if scores is None:
            scores = block_scores(params, ckpt.values, partition, norm_fn)
        return (_mask_from_indices(top_k_indices(scores, k), total, device),
                ckpt.rr_cursor)
    if policy.strategy == SelectionStrategy.ROUND_ROBIN:
        cursor = int(ckpt.rr_cursor)
        idx = (cursor + torch.arange(k)) % total
        new_cursor = torch.tensor((cursor + k) % total, dtype=torch.int32,
                                  device=device)
        return _mask_from_indices(idx, total, device), new_cursor
    if policy.strategy == SelectionStrategy.RANDOM:
        if rng is None:
            raise ValueError("RANDOM strategy requires an rng generator")
        idx = random_blocks(rng, total, k)
        return _mask_from_indices(idx, total, device), ckpt.rr_cursor
    raise ValueError(f"unknown strategy {policy.strategy}")


def save_step(ckpt: RunningCheckpoint, params: PyTree, step: int, *,
              policy: CheckpointPolicy, partition: BlockPartition,
              norm_fn: NormFn, rng: Optional[torch.Generator] = None,
              scores: Optional[torch.Tensor] = None,
              ) -> tuple[RunningCheckpoint, torch.Tensor]:
    """One partial-checkpoint update into a new checkpoint.

    Returns (new_checkpoint, saved_block_mask).
    """
    mask, cursor = select_save_mask(ckpt, params, policy=policy,
                                    partition=partition, norm_fn=norm_fn,
                                    rng=rng, scores=scores)
    new_values = select_blocks(ckpt.values, params, mask, partition)
    new_saved = torch.where(mask, torch.full_like(ckpt.saved_iter, int(step)),
                            ckpt.saved_iter)
    return RunningCheckpoint(new_values, new_saved, cursor), mask


def full_save(ckpt: RunningCheckpoint, params: PyTree,
              step: int) -> RunningCheckpoint:
    """Traditional full checkpoint: overwrite everything (r = 1 fast path)."""
    return RunningCheckpoint(
        values=clone_tree(params),
        saved_iter=torch.full_like(ckpt.saved_iter, int(step)),
        rr_cursor=ckpt.rr_cursor,
    )
