"""Fault-tolerance controller (paper §4.3, Figure 4), fabric-less.

The port of ``repro.core.controller.FTController`` without the tiered
fabric and the disk store. It owns the running checkpoint and drives:

1. Checkpoint coordination: every ``policy.partial_interval`` iterations
   (``full_interval`` for r = 1), score blocks, update the in-memory
   running checkpoint on the params' device, and wait for the device
   before training resumes (``save_seconds`` books device time).
2. Recovery coordination: on a failure (a lost-block mask), restore
   partially (PARTIAL: the masked_restore kernel on CUDA) or fully from
   the running checkpoint.

The partial save, by default, selects blocks with
:func:`repro_torch.core.checkpoint.select_save_mask` (PRIORITY scores are
the block_dist kernel on CUDA under the l2 norm) and copies only those
blocks in place with the scatter_save kernel
(:func:`repro_torch.kernels.fused_maintain.ops.tree_scatter_save`).
``inplace_save=False`` builds a new checkpoint through
:func:`repro_torch.core.checkpoint.save_step` instead.

``fabric=`` (ROADMAP slice 2) and ``store=`` (ROADMAP item 11) are not
ported yet and raise ``NotImplementedError``.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Optional

import torch

from repro_torch.core.blocks import block_scores, partition_pytree
from repro_torch.core.checkpoint import (RunningCheckpoint, full_save,
                                         init_running_checkpoint, save_step,
                                         select_save_mask)
from repro_torch.core.norms import get_norm
from repro_torch.core.policy import CheckpointPolicy, SelectionStrategy
from repro_torch.core.recovery import (apply_failure_and_recover,
                                       sample_failure_mask)
from repro_torch.device import DeviceLike, resolve_device, synchronize
from repro_torch.kernels.fused_maintain.ops import tree_scatter_save
from repro_torch.telemetry.recorder import NULL_RECORDER
from repro_torch.utils.tree import tree_leaves

PyTree = Any


class FTController:
    """Checkpoint + recovery coordinator for one training job.

    ``params`` must lie on ``device`` (``cuda`` unless asked otherwise).
    ``rng`` is a CPU ``torch.Generator`` for the failure masks and the
    RANDOM strategy (default: seeded 0).
    """

    def __init__(self, params: PyTree, policy: CheckpointPolicy, *,
                 norm_aux: Optional[dict] = None,
                 store: Optional[Any] = None,
                 score_fn: Optional[Callable] = None,
                 rng: Optional[torch.Generator] = None,
                 colocate: tuple = (),
                 fabric: Optional[Any] = None,
                 inplace_save: bool = True,
                 recorder: Optional[Any] = None,
                 device: DeviceLike = None):
        if fabric is not None:
            raise NotImplementedError(
                "the checkpoint fabric is not ported yet (ROADMAP slice 2, "
                "modules 6-8)")
        if store is not None:
            raise NotImplementedError(
                "the on-disk checkpoint store is not ported yet (ROADMAP "
                "item 11)")
        self.device = resolve_device(device)
        for x in tree_leaves(params):
            if x.device != self.device:
                raise ValueError(f"params lie on {x.device}, the controller "
                                 f"runs on {self.device}")
        self.policy = policy
        self.recorder = recorder if recorder is not None else NULL_RECORDER
        self.inplace_save = inplace_save
        self.partition = partition_pytree(params, policy.block_rows,
                                          colocate=colocate)
        self.norm_fn = get_norm(policy.norm, aux=norm_aux,
                                block_rows=policy.block_rows)
        self.ckpt = init_running_checkpoint(params, self.partition)
        self._score_fn = score_fn  # optional kernel-backed scorer
        self._rng = rng if rng is not None else torch.Generator().manual_seed(0)
        # bytes_mirrored and events stay 0 and [] without a store or a
        # fabric; they keep the reference's stats keys
        self.stats = self.recorder.scope("controller", {
            "saves": 0, "recoveries": 0, "save_seconds": 0.0,
            "blocks_saved": 0, "bytes_mirrored": 0,
            "save_bytes_moved": 0, "events": []})

    # -- checkpoint path ----------------------------------------------------

    def should_checkpoint(self, step: int) -> bool:
        interval = (self.policy.full_interval
                    if self.policy.fraction >= 1.0
                    else self.policy.partial_interval)
        return step > 0 and step % interval == 0

    def maybe_checkpoint(self, step: int, params: PyTree) -> bool:
        if not self.should_checkpoint(step):
            return False
        self.checkpoint_now(step, params)
        return True

    def checkpoint_now(self, step: int, params: PyTree) -> torch.Tensor:
        """Update the running checkpoint; returns the saved block mask."""
        t0 = time.perf_counter()
        moved0 = self.stats["save_bytes_moved"]
        pol = self.policy
        if pol.fraction >= 1.0 and pol.strategy != SelectionStrategy.PRIORITY:
            self.ckpt = full_save(self.ckpt, params, int(step))
            mask = torch.ones((self.partition.total_blocks,), dtype=torch.bool,
                              device=self.device)
        else:
            scores = None
            if pol.strategy == SelectionStrategy.PRIORITY \
                    and self._score_fn is not None:
                scores = self._score_fn(params, self.ckpt.values)
            if self.inplace_save:
                mask, cursor = select_save_mask(
                    self.ckpt, params, policy=pol, partition=self.partition,
                    norm_fn=self.norm_fn, rng=self._rng, scores=scores)
                idx = torch.nonzero(mask).flatten().cpu().numpy()
                values, moved = tree_scatter_save(
                    self.ckpt.values, params, idx, self.partition)
                saved = torch.where(
                    mask, torch.full_like(self.ckpt.saved_iter, int(step)),
                    self.ckpt.saved_iter)
                self.ckpt = RunningCheckpoint(values, saved, cursor)
                self.stats["save_bytes_moved"] += moved
            else:
                self.ckpt, mask = save_step(
                    self.ckpt, params, int(step), policy=pol,
                    partition=self.partition, norm_fn=self.norm_fn,
                    rng=self._rng, scores=scores)
        # the in-memory cache is consistent once the device is done; the
        # paper's training resumes here
        synchronize(self.device)
        n_blocks = int(torch.sum(mask))
        save_seconds = time.perf_counter() - t0
        self.stats["saves"] += 1
        self.stats["blocks_saved"] += n_blocks
        self.stats["save_seconds"] += save_seconds
        if self.recorder.enabled:
            self.recorder.histogram("controller/save_seconds").observe(
                save_seconds)
            self.recorder.event(
                "save", step=int(step), blocks=n_blocks,
                bytes_moved=self.stats["save_bytes_moved"] - moved0,
                seconds=save_seconds, mode="tree")
        return mask

    # -- recovery path ------------------------------------------------------

    def sample_failure(self, fraction: float) -> torch.Tensor:
        return sample_failure_mask(self._rng, self.partition, fraction,
                                   self.device)

    def on_failure(self, params: PyTree, lost_mask: torch.Tensor,
                   step: Optional[int] = None) -> tuple[PyTree, dict]:
        """Recover from a partial failure. Returns (params', diagnostics):
        ``full_sq``, ``partial_sq``, ``applied_sq`` and ``lost_blocks``."""
        lost_mask = lost_mask.to(device=self.device, dtype=torch.bool)
        if self.recorder.enabled:
            self.recorder.event(
                "failure", step=None if step is None else int(step),
                lost_blocks=int(lost_mask.sum()), failed_devices=0)
        recovered, info = apply_failure_and_recover(
            params, self.ckpt, lost_mask, self.policy.recovery,
            self.partition)
        self.stats["recoveries"] += 1
        out = {k: (float(v) if isinstance(v, torch.Tensor) else v)
               for k, v in info.items()}
        if self.recorder.enabled:
            self.recorder.record_recovery(
                step=None if step is None else int(step),
                lost_blocks=int(out["lost_blocks"]), tier_counts=None,
                applied_sq=out["applied_sq"])
        return recovered, out

    # -- analysis helpers ---------------------------------------------------

    def block_drift(self, params: PyTree) -> torch.Tensor:
        """Per-block distance between live params and the running ckpt."""
        return block_scores(params, self.ckpt.values, self.partition,
                            self.norm_fn)
