"""Fault-tolerance controller (paper §4.3, Figure 4).

The port of ``repro.core.controller.FTController``, without the disk store
(``store=``, ROADMAP item 11). It owns the running checkpoint and drives:

1. Checkpoint coordination: every ``policy.partial_interval`` iterations
   (``full_interval`` for r = 1), score blocks, update the in-memory
   running checkpoint on the params' device, and wait for the device
   before training resumes (``save_seconds`` books device time).
2. Recovery coordination: on a failure (a lost-block mask), restore
   partially (PARTIAL: the masked_restore kernel on CUDA) or fully from
   the running checkpoint.
3. Fabric coordination (``fabric=``, a :class:`FabricConfig` or a built
   :class:`CheckpointFabric`): maintain the anti-affine replicas and the
   XOR parity beside the running checkpoint, and route ``on_failure``
   through the tier planner, so each lost block recovers from the cheapest
   surviving tier. Trace-driven soaks use ``on_domain_event(s)`` and
   ``heal_domain``; every event's tier counts land in ``stats["events"]``.

Without a fabric the partial save selects with
:func:`repro_torch.core.checkpoint.select_save_mask` and copies the chosen
blocks in place with the scatter_save kernel; ``inplace_save=False`` builds
a new checkpoint through :func:`repro_torch.core.checkpoint.save_step`.

**Arena mode.** With an arena-capable fabric, the in-place save, no custom
``score_fn`` and (for PRIORITY) the l2 norm, the running checkpoint's
values live as one flat word arena (:mod:`repro_torch.core.arena`): the
maintenance sweep scores against it, and every partial save is one
arena_scatter launch sourced from the live arena, the sweep's replica, or
a fresh pack. The tree form is decoded on demand (recovery and analysis,
never the save). Top-k is a stable descending sort, so ties go to the
lower block id, as ``jax.lax.top_k`` does.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.core.arena import (arena_drift_scores, as_live_arena,
                                    pack_arena, unpack_arena)
from repro_torch.core.blocks import (block_scores, partition_pytree,
                                     tree_sq_norm)
from repro_torch.core.checkpoint import (RunningCheckpoint, full_save,
                                         init_running_checkpoint, save_step,
                                         select_save_mask, top_k_indices)
from repro_torch.core.norms import get_norm
from repro_torch.core.policy import (CheckpointPolicy, RecoveryMode,
                                     SelectionStrategy)
from repro_torch.core.recovery import (apply_failure_and_recover,
                                       perturbation_norms,
                                       sample_failure_mask)
from repro_torch.device import DeviceLike, resolve_device, synchronize
from repro_torch.kernels.fused_maintain.ops import (arena_scatter_save,
                                                    tree_scatter_save)
from repro_torch.telemetry.recorder import NULL_RECORDER
from repro_torch.utils.tree import tree_leaves

PyTree = Any


class FTController:
    """Checkpoint + recovery coordinator for one training job.

    ``params`` must lie on ``device`` (``cuda`` unless asked otherwise).
    ``rng`` is a CPU ``torch.Generator`` for the failure masks and the
    RANDOM strategy (default: seeded 0); its seed also seeds the numpy
    generator of the fabric's domain failures, as the reference derives
    it from its key.
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
        self._score_fn = score_fn  # optional kernel-backed scorer
        self._rng = rng if rng is not None else torch.Generator().manual_seed(0)
        self._np_rng = np.random.default_rng(self._rng.initial_seed())
        if fabric is not None:
            from repro_torch.fabric import CheckpointFabric, FabricConfig
            if isinstance(fabric, FabricConfig):
                fabric = CheckpointFabric(self.partition, fabric,
                                          recorder=self.recorder)
            if policy.recovery == RecoveryMode.FULL:
                # the tier planner is partial by nature (survivors keep
                # their live values)
                raise ValueError("fabric recovery is tiered/partial; use "
                                 "recovery=RecoveryMode.PARTIAL or drop "
                                 "the fabric for a FULL-recovery baseline")
        self.fabric = fabric
        self._arena_layout = None
        self._ckpt_arena: Optional[torch.Tensor] = None
        self._ckpt_dirty = False
        if (inplace_save and fabric is not None
                and fabric.arena_layout is not None and score_fn is None
                and (policy.strategy != SelectionStrategy.PRIORITY
                     or policy.norm == "l2")):
            self._arena_layout = fabric.arena_layout
            self._ckpt_arena = pack_arena(params, self._arena_layout)
            zeros = torch.zeros((self.partition.total_blocks,),
                                dtype=torch.int32, device=self.device)
            self._ckpt = RunningCheckpoint(None, zeros, zeros.new_zeros(()))
            self._ckpt_dirty = True   # the tree form is decoded on demand
        else:
            self._ckpt = init_running_checkpoint(params, self.partition)
        # bytes_mirrored stays 0 without a store; it keeps the reference's
        # stats keys
        self.stats = self.recorder.scope("controller", {
            "saves": 0, "recoveries": 0, "save_seconds": 0.0,
            "blocks_saved": 0, "bytes_mirrored": 0,
            "save_bytes_moved": 0, "events": []})

    # -- arena-native live state --------------------------------------------

    @property
    def arena_layout(self):
        """The flat-arena layout of the hot path (None = tree only)."""
        return self._arena_layout

    @property
    def arena_ready(self) -> bool:
        """True when the loops may feed :meth:`maintain` and
        :meth:`maybe_checkpoint` the live flat arena instead of the tree."""
        return self._arena_layout is not None

    def pack_live(self, params: PyTree, account: bool = False
                  ) -> torch.Tensor:
        """Pack a live tree into arena form. ``account=True`` books the
        pack's traffic (read the tree, write the arena) onto the fabric's
        maintenance bytes, as tree-stepping runners do."""
        if not self.arena_ready:
            raise RuntimeError("controller has no arena layout")
        if account and self.fabric is not None:
            t = self.fabric._traffic_model()
            self.fabric.stats["maintain_bytes_moved"] += \
                t["model"] + t["arena_bytes"]
            self.fabric.stats["live_packs"] += 1
        return pack_arena(params, self._arena_layout)

    def unpack_live(self, arena: torch.Tensor) -> PyTree:
        """Decode an arena back to tree form."""
        if not self.arena_ready:
            raise RuntimeError("controller has no arena layout")
        return unpack_arena(arena, self._arena_layout)

    def live_value_needed(self, step: int) -> bool:
        """True when this step's :meth:`maintain` or
        :meth:`maybe_checkpoint` reads the live value (runners skip their
        pack otherwise)."""
        if self.should_checkpoint(int(step)):
            return True
        return (self.fabric is not None
                and any(self.fabric.maintenance_due(int(step))))

    def _live_arena(self, params):
        return as_live_arena(params, self._arena_layout)

    # -- running checkpoint (arena-backed in arena mode) ---------------------

    @property
    def ckpt(self) -> RunningCheckpoint:
        """The running checkpoint. In arena mode the canonical values are
        the checkpoint arena; the tree form is decoded here on demand."""
        if self._ckpt_dirty:
            values = unpack_arena(self._ckpt_arena, self._arena_layout)
            self._ckpt = RunningCheckpoint(values, self._ckpt.saved_iter,
                                           self._ckpt.rr_cursor)
            self._ckpt_dirty = False
        return self._ckpt

    @ckpt.setter
    def ckpt(self, new: RunningCheckpoint) -> None:
        self._ckpt = new
        self._ckpt_dirty = False
        if self._arena_layout is not None:
            self._ckpt_arena = pack_arena(new.values, self._arena_layout)

    # -- checkpoint path ----------------------------------------------------

    def should_checkpoint(self, step: int) -> bool:
        interval = (self.policy.full_interval
                    if self.policy.fraction >= 1.0
                    else self.policy.partial_interval)
        return step > 0 and step % interval == 0

    def maybe_checkpoint(self, step: int, params: PyTree,
                         own_live: bool = False) -> bool:
        if not self.should_checkpoint(step):
            return False
        self.checkpoint_now(step, params, own_live=own_live)
        return True

    def checkpoint_now(self, step: int, params: PyTree,
                       own_live: bool = False) -> torch.Tensor:
        """Update the running checkpoint; returns the saved block mask.

        ``params`` may be the live flat arena (requires :attr:`arena_ready`):
        the partial save then sources straight from it, and a full save is
        one contiguous copy. ``own_live`` rides along to the freshness
        maintain after the save (see :meth:`maintain`)."""
        t0 = time.perf_counter()
        pol = self.policy
        live = self._live_arena(params)
        full_plain = (pol.fraction >= 1.0
                      and pol.strategy != SelectionStrategy.PRIORITY)
        total = self.partition.total_blocks
        if live is not None and full_plain:
            ck = self._ckpt
            self._ckpt_arena = live.clone()
            self._ckpt = RunningCheckpoint(
                ck.values, torch.full_like(ck.saved_iter, int(step)),
                ck.rr_cursor)
            self._ckpt_dirty = True
            mask = torch.ones((total,), dtype=torch.bool, device=self.device)
        elif self._arena_layout is not None and not full_plain:
            mask = self._arena_checkpoint(step, params)
        elif full_plain:
            self.ckpt = full_save(self.ckpt, params, int(step))
            mask = torch.ones((total,), dtype=torch.bool, device=self.device)
        else:
            if live is not None:
                raise ValueError("live-arena saves need the arena checkpoint "
                                 "path (an arena-capable fabric)")
            scores = None
            if pol.strategy == SelectionStrategy.PRIORITY:
                if self._score_fn is not None:
                    scores = self._score_fn(params, self.ckpt.values)
                elif (self.fabric is not None
                        and self.fabric.last_scores_step == int(step)
                        and pol.norm == "l2"):
                    # this step's sweep already measured the drift
                    scores = self.fabric.last_scores
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
        if self.fabric is not None:
            # the save invalidated the drift the cached scores measured
            self.fabric.invalidate_scores()
        # the in-memory cache is consistent once the device is done; the
        # paper's training resumes here
        synchronize(self.device)
        n_blocks = int(torch.sum(mask))
        self.stats["saves"] += 1
        self.stats["blocks_saved"] += n_blocks
        self.stats["save_seconds"] += time.perf_counter() - t0
        if self.fabric is not None and not self.fabric.is_fresh(int(step)):
            # keep the redundancy tiers at least as fresh as the checkpoint
            self.fabric.maintain(int(step), params, force=True,
                                 own_live=own_live)
        return mask

    def _arena_checkpoint(self, step: int, params: PyTree) -> torch.Tensor:
        """Partial save in arena mode: select blocks, then one arena_scatter
        launch into the checkpoint arena, sourced from the live arena when
        given, else from the sweep's replica arena of this step, else from
        a fresh pack."""
        pol = self.policy
        total = self.partition.total_blocks
        k = self.partition.blocks_for_k(pol.fraction)
        ck = self._ckpt
        cursor = ck.rr_cursor
        live = self._live_arena(params)
        if pol.strategy == SelectionStrategy.PRIORITY:
            if (self.fabric.last_scores_step == int(step)
                    and self.fabric.last_scores is not None):
                scores = self.fabric.last_scores
            else:
                scores = self._arena_scores(params)
            idx = top_k_indices(scores, k).cpu().numpy()
        elif pol.strategy == SelectionStrategy.ROUND_ROBIN:
            c = int(ck.rr_cursor)
            idx = (c + np.arange(k)) % total
            cursor = torch.tensor((c + k) % total, dtype=torch.int32,
                                  device=self.device)
        elif pol.strategy == SelectionStrategy.RANDOM:
            idx = torch.randperm(total, generator=self._rng)[:k].numpy()
        else:
            raise ValueError(f"unknown strategy {pol.strategy}")
        mask = np.zeros((total,), bool)
        mask[idx] = True
        rep = self.fabric.replicas
        if live is not None:
            src = live
        elif rep is not None and rep.arena is not None \
                and rep.is_fresh(int(step)):
            src = rep.arena_local()
        else:
            src = pack_arena(params, self._arena_layout)
        self._ckpt_arena, moved = arena_scatter_save(
            self._ckpt_arena, src, self._arena_layout, idx)
        mask_t = torch.from_numpy(mask).to(self.device)
        saved = torch.where(mask_t, torch.full_like(ck.saved_iter, int(step)),
                            ck.saved_iter)
        self._ckpt = RunningCheckpoint(ck.values, saved, cursor)
        self._ckpt_dirty = True
        self.stats["save_bytes_moved"] += moved
        return mask_t

    def _arena_scores(self, params: PyTree) -> torch.Tensor:
        """Squared-L2 drift per block against the checkpoint arena (a pack
        first when the live state is a tree): the PRIORITY fallback when
        this step's sweep did not cache scores."""
        live = self._live_arena(params)
        if live is None:
            live = pack_arena(params, self._arena_layout)
        return arena_drift_scores(live, self._ckpt_arena, self._arena_layout)

    def maintain(self, step: int, params: PyTree,
                 own_live: bool = False) -> None:
        """Per-iteration fabric upkeep (no-op without a fabric). When a
        PRIORITY save follows at this step and can use the sweep's scores,
        the running checkpoint rides along so the sweep scores in the same
        read: the loops call maintain() before maybe_checkpoint().
        ``params`` may be the live flat arena; ``own_live=True`` hands it
        over as the replica itself (no copy)."""
        if self.fabric is None:
            return
        want_scores = (self.policy.strategy == SelectionStrategy.PRIORITY
                       and self.policy.norm == "l2"
                       and self._score_fn is None
                       and self.should_checkpoint(int(step)))
        if not want_scores:
            ckpt_values = None
        elif self._arena_layout is not None:
            ckpt_values = self._ckpt_arena
        else:
            ckpt_values = self.ckpt.values
        self.fabric.maintain(int(step), params, ckpt_values=ckpt_values,
                             own_live=own_live)

    # -- recovery path ------------------------------------------------------

    def sample_failure(self, fraction: float) -> torch.Tensor:
        return sample_failure_mask(self._rng, self.partition, fraction,
                                   self.device)

    def sample_domain_failure(self, kind: str = "host",
                              ) -> tuple[np.ndarray, np.ndarray]:
        """Correlated whole-domain failure -> (lost mask, failed devices);
        needs a fabric (it owns the topology)."""
        if self.fabric is None:
            raise RuntimeError("domain failures need a fabric")
        return self.fabric.sample_domain_failure(self._np_rng, kind)

    def on_domain_event(self, params: PyTree, kind: str, index: int,
                        step: Optional[int] = None) -> tuple[PyTree, dict]:
        """Fail one specific domain, recover, and keep it dead in the
        fabric's view until :meth:`heal_domain` (elastic fabrics re-plan).
        Events on fully dead domains are skipped."""
        if self.fabric is None:
            raise RuntimeError("domain events need a fabric")
        lost, failed = self.fabric.domain_failure(kind, index)
        if failed.size == 0:
            return params, {"skipped": True, "kind": kind, "index": index}
        recovered, info = self.on_failure(params, lost,
                                          failed_devices=failed, step=step,
                                          persist_failure=True)
        info["kind"], info["index"] = kind, index
        return recovered, info

    def on_domain_events(self, params: PyTree, events,
                         step: Optional[int] = None) -> tuple[PyTree, dict]:
        """Several events in the same step: one correlated multi-domain
        loss. Every event's loss is resolved against the pre-failure view,
        then the union recovers in one tier-planned pass. A single event
        is :meth:`on_domain_event`."""
        if self.fabric is None:
            raise RuntimeError("domain events need a fabric")
        events = [(str(k), int(i)) for k, i in events]
        if len(events) == 1:
            return self.on_domain_event(params, *events[0], step=step)
        lost = np.zeros((self.partition.total_blocks,), bool)
        failed_parts, applied = [], []
        for kind, index in events:
            ev_lost, ev_failed = self.fabric.domain_failure(kind, index)
            if ev_failed.size == 0:
                continue
            lost |= ev_lost
            failed_parts.append(ev_failed)
            applied.append({"kind": kind, "index": index,
                            "failed_devices": int(ev_failed.size)})
        if not failed_parts:
            return params, {"skipped": True, "events": applied}
        failed = np.unique(np.concatenate(failed_parts))
        recovered, info = self.on_failure(params, lost,
                                          failed_devices=failed, step=step,
                                          persist_failure=True)
        info["events"] = applied
        return recovered, info

    def scrub(self, step: Optional[int] = None) -> dict:
        """Run the fabric's silent-error integrity pass. A corruption the
        scrub corrects applies no perturbation (the exact bits are back);
        the recorder prices it once the full telemetry is ported (ROADMAP
        item 9). ``checked=False`` without an integrity-capable fabric."""
        if self.fabric is None:
            return {"checked": False, "detected": 0, "corrected": 0,
                    "reports": []}
        out = self.fabric.scrub(step=step)
        if self.recorder.enabled and out["detected"]:
            self.recorder.record_recovery(
                step=None if step is None else int(step), lost_blocks=0,
                tier_counts={"SILENT_ERROR": out["detected"]},
                applied_sq=0.0, silent_detected=out["detected"],
                silent_corrected=out["corrected"])
        return out

    def heal_domain(self, kind: str, index: int,
                    params: Optional[PyTree] = None,
                    step: Optional[int] = None) -> dict:
        """Re-admit a healed domain to the fabric's view."""
        if self.fabric is None:
            raise RuntimeError("domain healing needs a fabric")
        return self.fabric.heal_domain(kind, index, params=params, step=step)

    def on_failure(self, params: PyTree, lost_mask,
                   failed_devices=None, step: Optional[int] = None,
                   persist_failure: Optional[bool] = None,
                   ) -> tuple[PyTree, dict]:
        """Recover from a partial failure. Returns (params', diagnostics):
        ``full_sq``, ``partial_sq``, ``applied_sq`` and ``lost_blocks``,
        and with a fabric the per-tier counts and perturbations.

        With a fabric each lost block resolves to the cheapest surviving
        tier; ``failed_devices`` names the dead devices of a correlated
        failure (None: the paper's uniform block loss). ``params`` may be
        the live flat arena: it is decoded, recovered, and re-packed."""
        live = self._live_arena(params)
        if live is not None:
            recovered, info = self.on_failure(
                self.unpack_live(live), lost_mask,
                failed_devices=failed_devices, step=step,
                persist_failure=persist_failure)
            return self.pack_live(recovered), info
        if self.fabric is not None:
            lost = (lost_mask.cpu().numpy() if isinstance(
                lost_mask, torch.Tensor) else np.asarray(lost_mask)) \
                .astype(bool)
            ckpt = self.ckpt
            info = perturbation_norms(params, ckpt,
                                      torch.from_numpy(lost).to(self.device),
                                      self.partition)
            recovered, tier_info = self.fabric.on_failure(
                params, ckpt.values, lost, failed_devices=failed_devices,
                step=step, persist_failure=persist_failure)
            info["applied_sq"] = tree_sq_norm(recovered, params)
            info["lost_blocks"] = int(lost.sum())
            info.update(tier_info)
            self.stats["events"].append({
                "step": None if step is None else int(step),
                "lost_blocks": info["lost_blocks"],
                "failed_devices": info.get("failed_devices", 0),
                "tier_counts": info.get("tier_counts"),
                "applied_sq": float(info["applied_sq"]),
                "placement": info.get("placement"),
            })
        else:
            recovered, info = apply_failure_and_recover(
                params, self.ckpt, torch.as_tensor(lost_mask).to(
                    device=self.device, dtype=torch.bool),
                self.policy.recovery, self.partition)
        self.stats["recoveries"] += 1
        out = {k: (float(v) if isinstance(v, torch.Tensor) else v)
               for k, v in info.items()}
        if self.recorder.enabled:
            self.recorder.record_recovery(
                step=None if step is None else int(step),
                lost_blocks=int(out["lost_blocks"]),
                tier_counts=out.get("tier_counts"),
                applied_sq=out["applied_sq"])
        return recovered, out

    # -- analysis helpers ---------------------------------------------------

    def block_drift(self, params: PyTree) -> torch.Tensor:
        """Per-block distance between live params and the running ckpt."""
        return block_scores(params, self.ckpt.values, self.partition,
                            self.norm_fn)
