"""Fault-tolerance controller (paper §4.3, Figure 4).

The port of ``repro.core.controller.FTController``. It owns the running
checkpoint and drives:

1. Checkpoint coordination: every ``policy.partial_interval`` iterations
   (``full_interval`` for r = 1), score blocks, update the in-memory
   running checkpoint on the params' device, and wait for the device
   before training resumes (``save_seconds`` books device time); then,
   with a ``store`` (:class:`repro_torch.checkpoint_io.
   ShardedCheckpointStore`), mirror the saved blocks to disk (in the
   background under ``policy.async_persist``) and the fabric's parity
   after them.
2. Recovery coordination: on a failure (a lost-block mask), restore
   partially (PARTIAL: the masked_restore kernel on CUDA) or fully from
   the running checkpoint; the fabric's DISK tier reads the store, and a
   store marked ``must_reload`` replaces the in-memory checkpoint.
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

**On a mesh** (``mesh=``, with a fabric) the controller is arena-native:
each rank holds its span of the checkpoint arena, a partial save selects
the same blocks on every rank (the sweep's scores are summed over the mesh)
and copies their words inside the rank's span (one arena_scatter launch),
and a recovery gathers the live and checkpoint arenas and the tiers at the
mesh's first position, restores there and scatters the recovered spans
back; the other ranks take its report. :meth:`rebind_arena` moves the
checkpoint to the fabric's new layout after an elastic resize. A mesh
without the arena checkpoint, or with a store, raises.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.checkpoint_io.store import gather_tiles
from repro_torch.core.arena import (arena_drift_scores, as_live_arena,
                                    pack_arena, unpack_arena)
from repro_torch.core.blocks import (block_scores, partition_pytree,
                                     random_blocks)
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
from repro_torch.kernels.block_dist.ops import tree_block_scores
from repro_torch.kernels.fused_maintain.ops import (arena_scatter_save,
                                                    tree_scatter_save)
from repro_torch.telemetry.recorder import NULL_RECORDER
from repro_torch.utils.tree import tree_leaves

PyTree = Any


class FTController:
    """Checkpoint + recovery coordinator for one training job.

    ``params`` must lie on ``device`` (``cuda`` unless asked otherwise).
    ``rng`` is a CPU ``torch.Generator`` for the failure masks and the
    RANDOM strategy (default: seeded 0), or a
    :class:`~repro_torch.core.blocks.ReplayDraws` of recorded draws; its
    seed also seeds the numpy generator of the fabric's domain failures,
    as the reference derives it from its key.
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
                 device: DeviceLike = None,
                 mesh: Optional[Any] = None):
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
                                          recorder=self.recorder, mesh=mesh)
            elif self.recorder.enabled:
                fabric.attach_recorder(self.recorder)
            if policy.recovery == RecoveryMode.FULL:
                # the tier planner is partial by nature (survivors keep
                # their live values)
                raise ValueError("fabric recovery is tiered/partial; use "
                                 "recovery=RecoveryMode.PARTIAL or drop "
                                 "the fabric for a FULL-recovery baseline")
        if mesh is not None and (fabric is None or fabric.mesh is None):
            raise ValueError("a controller on a mesh needs a fabric on that "
                             "mesh")
        self.fabric = fabric
        self.mesh = None if fabric is None else fabric.mesh
        self._arena_layout = None
        self._ckpt_arena: Optional[torch.Tensor] = None
        self._ckpt_dirty = False
        if (inplace_save and fabric is not None
                and fabric.arena_layout is not None and score_fn is None
                and (policy.strategy != SelectionStrategy.PRIORITY
                     or policy.norm == "l2")):
            self._arena_layout = fabric.arena_layout
            self._ckpt_arena = (pack_arena(params, self._arena_layout)
                                if self.mesh is None
                                else fabric.live_span(params))
            zeros = torch.zeros((self.partition.total_blocks,),
                                dtype=torch.int32, device=self.device)
            self._ckpt = RunningCheckpoint(None, zeros, zeros.new_zeros(()))
            self._ckpt_dirty = True   # the tree form is decoded on demand
        else:
            if self.mesh is not None:
                raise ValueError(
                    "a controller on a mesh needs the arena checkpoint "
                    "(in-place saves, no custom score_fn, the l2 norm under "
                    "PRIORITY)")
            self._ckpt = init_running_checkpoint(params, self.partition)
        if self.mesh is not None and store is not None:
            raise ValueError("the disk store does not run on a mesh")
        self.store = store
        if store is not None:
            store.attach_recorder(self.recorder)
            kw = {}
            if fabric is not None:
                # domain-keyed disk layout: a DISK-tier read after a domain
                # loss touches only the needed blocks' bytes
                kw = dict(homes=fabric.view.homes, domains=fabric.domains)
            if self._arena_layout is not None:
                # arena segments: one append a host a save, sourced from
                # the checkpoint arena
                kw["arena_layout"] = self._arena_layout
                kw["arena_values"] = self._ckpt_arena
            store.init(params, self.partition, **kw)
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
        if self.mesh is not None:
            return self.fabric.live_span(params)
        if account and self.fabric is not None:
            t = self.fabric._traffic_model()
            self.fabric.stats["maintain_bytes_moved"] += \
                t["model"] + t["arena_bytes"]
            self.fabric.stats["live_packs"] += 1
        return pack_arena(params, self._arena_layout)

    def unpack_live(self, arena: torch.Tensor) -> PyTree:
        """Decode an arena back to tree form (a whole arena: on a mesh,
        the spans gathered first)."""
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
        if self.mesh is not None:
            return params if self.fabric.is_span(params) else None
        return as_live_arena(params, self._arena_layout)

    def rebind_arena(self, old_ranks: list, new_ranks: list) -> None:
        """Adopt the fabric's current arena layout after an elastic resize
        (:meth:`CheckpointFabric.resize_mesh`): the checkpoint's spans move
        from the old mesh's ranks to the new mesh's
        (:func:`~repro_torch.distributed.collectives.respan`, bit for bit:
        the data region does not depend on the shard count), and the save
        bookkeeping (``saved_iter``, the round-robin cursor) is taken from
        the new mesh's first rank, so a rank that sat outside the shrunk
        mesh rejoins in step. Every rank calls it."""
        import torch.distributed as dist
        from repro_torch.distributed.collectives import respan
        if not self.arena_ready or self.fabric is None:
            raise RuntimeError("rebind_arena needs an arena-native "
                               "controller with a fabric")
        old, layout = self._arena_layout, self.fabric.arena_layout
        self._arena_layout = layout
        if layout is old:
            return
        self._ckpt_arena = respan(
            self._ckpt_arena, list(old_ranks), old.shard_words,
            list(new_ranks), layout.shard_words, old.data_words,
            torch.int32, self.device)
        ck = self._ckpt
        if dist.is_initialized() and dist.get_world_size() > 1:
            box = [(ck.saved_iter.cpu(), ck.rr_cursor.cpu())]
            dist.broadcast_object_list(box, src=int(new_ranks[0]))
            ck = RunningCheckpoint(None, box[0][0].to(self.device),
                                   box[0][1].to(self.device))
        self._ckpt = RunningCheckpoint(None, ck.saved_iter, ck.rr_cursor)
        self._ckpt_dirty = self._ckpt_arena is not None

    # -- running checkpoint (arena-backed in arena mode) ---------------------

    @property
    def ckpt(self) -> RunningCheckpoint:
        """The running checkpoint. In arena mode the canonical values are
        the checkpoint arena; the tree form is decoded here on demand."""
        if self._ckpt_dirty:
            if self.mesh is not None:
                raise ValueError("on a mesh the checkpoint is this rank's "
                                 "span of the checkpoint arena "
                                 "(_ckpt_arena); gather it to decode")
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

    def _release_ckpt_tree(self) -> None:
        """Arena mode: drop the checkpoint's decoded tree (the checkpoint
        arena stays canonical and :attr:`ckpt` decodes it again on
        demand), so that the tree a recovery read does not stay alive as a
        second copy of the model through the steps after it."""
        if self._arena_layout is not None and self._ckpt.values is not None:
            self._ckpt = RunningCheckpoint(None, self._ckpt.saved_iter,
                                           self._ckpt.rr_cursor)
            self._ckpt_dirty = True

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
        if self.fabric is not None and self.fabric.has_pending_maintenance:
            # consume point: the save may read the published slot and
            # mirrors parity after it; the fence comes first, outside the
            # save timer, so an in-flight sweep books as fence time
            self.fabric.block_until_maintained()
        t0 = time.perf_counter()
        moved0 = self.stats["save_bytes_moved"]
        pol = self.policy
        live = self._live_arena(params)
        full_plain = (pol.fraction >= 1.0
                      and pol.strategy != SelectionStrategy.PRIORITY)
        total = self.partition.total_blocks
        if live is not None and full_plain:
            ck = self._ckpt
            self._ckpt_arena = live.clone()
            self._ckpt = RunningCheckpoint(
                None, torch.full_like(ck.saved_iter, int(step)),
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
                seconds=save_seconds,
                mode="arena" if self._arena_layout is not None else "tree")
        if self.store is not None:
            self._mirror(step, mask)
        if self.fabric is not None:
            if not self.fabric.is_fresh(int(step)):
                # keep the redundancy tiers at least as fresh as the
                # checkpoint
                self.fabric.maintain(int(step), params, force=True,
                                     own_live=own_live)
            codec = self.fabric.parity
            if (self.store is not None and codec is not None
                    and codec.parity is not None):
                if self.fabric.has_pending_maintenance:
                    self.fabric.block_until_maintained()
                # blocks whose domain shard died stay reconstructable
                # offline from the survivors and the parity
                self.stats["bytes_mirrored"] += self.store.write_parity(
                    int(step), codec.parity, codec.parity_homes,
                    domains=self.fabric.domains, members=codec.members)
        return mask

    def _mirror(self, step: int, mask: torch.Tensor) -> None:
        """Mirror the saved blocks to the store: in arena mode the touched
        tiles of the checkpoint arena (one gather on the device, one copy
        to the host), else the tree's blocks."""
        bg = self.policy.async_persist
        if self._arena_layout is not None:
            mask_np = mask.cpu().numpy()
            tiles = self._arena_layout.tiles_for_blocks(np.nonzero(mask_np)[0])
            self.stats["bytes_mirrored"] += self.store.write_arena(
                mask_np, tiles, gather_tiles(self._ckpt_arena, tiles), step,
                background=bg)
        else:
            self.stats["bytes_mirrored"] += self.store.write_blocks(
                mask, self.ckpt.values, step, background=bg)

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
            idx = random_blocks(self._rng, total, k).numpy()
        else:
            raise ValueError(f"unknown strategy {pol.strategy}")
        mask = np.zeros((total,), bool)
        mask[idx] = True
        rep = self.fabric.replicas
        published = (rep is not None and rep.arena is not None
                     and rep.is_fresh(int(step)))
        if self.mesh is not None:
            # this rank's span of the live values: the same selection on
            # every rank, each copying the words inside its own span
            src = live if live is not None else self.fabric.live_span(params)
        elif self.fabric.cfg.async_maintain and published:
            # async: the published slot holds this step's values bit for
            # bit, and reading it keeps the save off the live arena the
            # next step updates in place
            src = rep.arena_local()
        elif live is not None:
            src = live
        elif published:
            src = rep.arena_local()
        else:
            src = pack_arena(params, self._arena_layout)
        span = (None if self.mesh is None
                else self._arena_layout.span(self.fabric.comm.pos))
        self._ckpt_arena, moved = arena_scatter_save(
            self._ckpt_arena, src, self._arena_layout, idx, span=span)
        mask_t = torch.from_numpy(mask).to(self.device)
        saved = torch.where(mask_t, torch.full_like(ck.saved_iter, int(step)),
                            ck.saved_iter)
        self._ckpt = RunningCheckpoint(None, saved, cursor)
        self._ckpt_dirty = True
        self.stats["save_bytes_moved"] += moved
        return mask_t

    def _arena_scores(self, params: PyTree) -> torch.Tensor:
        """Squared-L2 drift per block against the checkpoint arena (a pack
        first when the live state is a tree): the PRIORITY fallback when
        this step's sweep did not cache scores."""
        if self.mesh is not None:
            raise ValueError("on a mesh the scores come from the sweep: "
                             "call maintain() before the save")
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
        scrub corrects applies no perturbation (the exact bits are back),
        and the recorder prices it at 0. ``checked=False`` without an
        integrity-capable fabric."""
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
        if self.mesh is not None:
            return self._on_failure_mesh(params, lost_mask, failed_devices,
                                         step, persist_failure)
        live = self._live_arena(params)
        if live is not None:
            # the tiers read the live values and the checkpoint and write
            # new leaves only: both are decoded as views of their arenas
            # (no two extra copies of the model beside the tiers' outputs),
            # and the recovered leaves go back into the live arena in place
            # (unless it is the replica too), as a train step's update does
            self._ckpt = RunningCheckpoint(
                unpack_arena(self._ckpt_arena, self._arena_layout,
                             copy=False),
                self._ckpt.saved_iter, self._ckpt.rr_cursor)
            self._ckpt_dirty = False
            try:
                recovered, info = self.on_failure(
                    unpack_arena(live, self._arena_layout, copy=False),
                    lost_mask, failed_devices=failed_devices, step=step,
                    persist_failure=persist_failure)
            finally:
                self._release_ckpt_tree()
            rep = self.fabric.replicas if self.fabric is not None else None
            into = None if rep is not None and rep.arena is live else live
            return pack_arena(recovered, self._arena_layout, out=into), info
        if self.recorder.enabled:
            self.recorder.event(
                "failure", step=None if step is None else int(step),
                lost_blocks=int(np.asarray(torch.as_tensor(lost_mask).cpu(),
                                           bool).sum()),
                failed_devices=(0 if failed_devices is None
                                else int(np.asarray(failed_devices).size)))
        ckpt = self.ckpt
        if self.store is not None and self.store.must_reload:
            # the in-memory checkpoint is gone too: reload it from disk
            ckpt = RunningCheckpoint(self.store.read_all(), ckpt.saved_iter,
                                     ckpt.rr_cursor)
        if self.fabric is not None:
            lost = (lost_mask.cpu().numpy() if isinstance(
                lost_mask, torch.Tensor) else np.asarray(lost_mask)) \
                .astype(bool)
            info = perturbation_norms(params, ckpt,
                                      torch.from_numpy(lost).to(self.device),
                                      self.partition)
            recovered, tier_info = self.fabric.on_failure(
                params, ckpt.values, lost, failed_devices=failed_devices,
                step=step, disk_reader=None if self.store is None
                else self.store.read_blocks,
                persist_failure=persist_failure)
            info["applied_sq"] = tree_block_scores(
                recovered, params, self.partition).sum()
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
                params, ckpt, torch.as_tensor(lost_mask).to(
                    device=self.device, dtype=torch.bool),
                self.policy.recovery, self.partition)
        self.stats["recoveries"] += 1
        out = {k: (float(v) if isinstance(v, torch.Tensor) else v)
               for k, v in info.items()}
        if self.recorder.enabled:
            # the ledger entry; an async recovery also says which epoch it
            # restored, so a stale published slot is priced explicitly
            extra = {}
            if "recovered_epoch" in out:
                extra["recovered_epoch"] = int(out["recovered_epoch"])
                extra["staleness"] = int(out.get("staleness", 0))
            self.recorder.record_recovery(
                step=None if step is None else int(step),
                lost_blocks=int(out["lost_blocks"]),
                tier_counts=out.get("tier_counts"),
                applied_sq=out["applied_sq"],
                tier_sq=out.get("tier_sq"),
                failed_devices=out.get("failed_devices", 0), **extra)
        return recovered, out

    def _on_failure_mesh(self, live, lost_mask, failed_devices, step,
                         persist_failure) -> tuple[PyTree, dict]:
        """A recovery on a mesh. Every rank keeps the failed devices dead
        in the view; every member restores its own span of the live arena
        in place under the same plan
        (:meth:`~repro_torch.fabric.fabric.CheckpointFabric.recover_span`),
        and all of them price the loss alike; the report goes to the ranks
        outside the mesh from its first rank; then every rank ends the
        failure (counters and, elastic, the re-plan). ``live`` is the
        rank's span of the arena-resident state (None outside the mesh),
        or the whole tree on every rank of the mesh: its span is packed
        and recovered, and the recovered spans are gathered into a new
        tree."""
        import torch.distributed as dist
        fab, comm = self.fabric, self.fabric.comm
        lost = (lost_mask.cpu().numpy() if isinstance(lost_mask, torch.Tensor)
                else np.asarray(lost_mask)).astype(bool)
        failed, at = fab.begin_failure(failed_devices, step, persist_failure)
        if self.recorder.enabled:
            self.recorder.event("failure", step=None if step is None
                                else int(step), lost_blocks=int(lost.sum()),
                                failed_devices=int(failed.size))
        out = None
        if comm is not None:
            span = self._live_arena(live)
            tree = span is None
            if tree:
                span = fab.live_span(live)
            out = fab.recover_span(span, self._ckpt_arena,
                                   fab.planner.plan(lost, failed, at), lost)
            out["lost_blocks"] = int(lost.sum())
            if tree:
                live = unpack_arena(comm.all_gather(span),
                                    self._arena_layout)
        elif live is not None:
            raise ValueError("a rank outside the mesh holds no live state "
                             "to recover")
        if dist.is_initialized() and dist.get_world_size() > 1:
            box = [out]
            dist.broadcast_object_list(box, src=int(fab.mesh.ranks[0]))
            out = box[0]
        out = fab.end_failure(out, failed, at, live)
        self.stats["events"].append({
            "step": None if step is None else int(step),
            "lost_blocks": out["lost_blocks"],
            "failed_devices": out["failed_devices"],
            "tier_counts": out.get("tier_counts"),
            "applied_sq": float(out["applied_sq"]),
            "placement": out.get("placement")})
        self.stats["recoveries"] += 1
        if self.recorder.enabled:
            self.recorder.record_recovery(
                step=None if step is None else int(step),
                lost_blocks=int(out["lost_blocks"]),
                tier_counts=out.get("tier_counts"),
                applied_sq=out["applied_sq"], tier_sq=out.get("tier_sq"),
                failed_devices=out.get("failed_devices", 0),
                recovered_epoch=int(out["recovered_epoch"]),
                staleness=int(out["staleness"]))
        return live, out

    # -- analysis helpers ---------------------------------------------------

    def block_drift(self, params: PyTree) -> torch.Tensor:
        """Per-block distance between live params and the running ckpt."""
        return block_scores(params, self.ckpt.values, self.partition,
                            self.norm_fn)
