"""The checkpoint fabric facade: cluster view + replicas + parity + planner.

The port of ``repro.fabric.fabric`` on its synchronous, single-process
arena path. ``CheckpointFabric`` is the one object the FTController talks
to:

- ``maintain(step, params)``      refresh replicas and re-encode parity on
                                  their intervals (idempotent per step): one
                                  arena_maintain sweep when both are due;
- ``sample_domain_failure(...)``  a correlated whole-domain loss: the
                                  lost-block mask and the failed devices;
- ``domain_failure(kind, index)`` the lost mask of one specific domain;
- ``on_failure(...)``             tier-plan the lost blocks, recover each
                                  from the cheapest surviving tier, report
                                  per-tier perturbations; with
                                  ``elastic=True`` the failed devices stay
                                  dead and the placement engine re-homes,
                                  re-seeds and re-stripes over the
                                  survivors;
- ``heal_domain(kind, index)``    re-admit a healed domain (and, elastic,
                                  rebalance onto it);
- ``scrub(step)``                 the RS tier's integrity pass over the coded
                                  snapshot: detect, localize and correct
                                  silent bit flips
                                  (``inject_arena_bit_flip`` makes one);
- ``block_until_maintained()``    the fence: waits for the last sweep (under
                                  async maintenance, settles the pending
                                  epoch).

Three maintenance paths, as in the reference: the arena sweep (the
default), the per-leaf sweep (``arena=False``, and every tree with a dtype
the arena cannot pack: f64, int64, bool, complex), and the per-component
passes (``fused=False``, one-tier fabrics, off-interval steps). The codec
is XOR parity (``rs_parity=0``) or RS(k, m) (``rs_parity=m``), which
re-encodes its rows from the sweep's snapshot.

The failure domains are logical: ``FabricConfig()``'s 8 devices, 4 hosts
and 2 racks are bookkeeping over the one device the tensors live on.

**Async maintenance** (``async_maintain=True``, the arena path fed the live
arena): a two-slot snapshot with an epoch/publish protocol. A maintain
settles the previous epoch, copies the live arena into the inactive slot,
flips the slot, publishes it (replica, parity and scores of one step) as
``published_epoch``, and starts the sweep without waiting for it. On CUDA
the copy runs on the current stream and the sweep (arena_maintain, or the
RS encode) on a side stream that waits for the copy, so the next step's
in-place update of the live arena may start at once; the sweep reads the
slot and the checkpoint arena and writes the parity and the scores, which
nothing touches until the fence: the next maintain, and every consume
point (``on_failure``, ``heal_domain``, ``scrub``, the controller's save,
the loops' epoch boundary) settles the pending epoch first. Every tensor
that crosses the streams is marked with ``record_stream``. On the CPU the
same protocol runs without streams. ``overlap_efficiency`` is the share of
the sweeps' wall time hidden under the caller's work; a recovery behind the
published epoch reports ``recovered_epoch`` and ``staleness``.

**On a mesh** (``mesh=``, a :class:`~repro_torch.launch.mesh.Mesh` of
``n_devices`` ranks; position ``i`` is logical device ``i``) the arena is
sharded: the layout is built with ``shards = n`` and each rank holds its
span of the live arena, the checkpoint and the replica, and its own rows
of the parity. A maintain runs the arena_maintain kernel on the rank's
span only (:class:`~repro_torch.kernels.fused_maintain.ops.
SpanMaintainProgram`: its partial parity goes to the rows' owners by one
all-to-all and the parity_xor kernel folds it there; the scores are summed
over the mesh), and ships the span's replica to the rank at the
anti-affine rotation (``_bind_mesh``: the shift that puts the most spans
on another host, then on another rack), booking ``ici_bytes_moved`` and
``dcn_bytes_moved``. A recovery gathers the tiers at the mesh's first
position, plans and restores there (a failure-rate path) and scatters the
recovered spans back. ``resize_mesh`` re-binds the fabric to a shrunk or
re-grown mesh. The meshed fabric needs the arena pipeline on an all-f32
model, the XOR codec and synchronous maintenance: anything else raises.
Ranks left out of a shrunk mesh keep the bookkeeping (view, placement,
striping) and skip the data work.

The reference's ``use_pallas`` option is gone: each kernel runs on CUDA
tensors and its plain version on
CPU tensors. With a real recorder attached the fabric emits the
reference's ``maintain`` (inside a fenced ``maintain`` span; an async
epoch's deferred span covers [dispatch, fence]), ``tier_fallback``,
``rehome`` and ``heal`` events, the ``fabric/overlap_efficiency`` gauge
and its ``fabric/fence_seconds`` histogram; with ``NULL_RECORDER`` every
emit point is skipped.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.arena import (arena_block_homes, arena_compatible,
                                    as_live_arena, build_arena_layout,
                                    pack_arena)
from repro_torch.core.blocks import BlockPartition
from repro_torch.fabric.domains import FailureDomainMap
from repro_torch.fabric.parity import ParityCodec
from repro_torch.fabric.placement import (ClusterView, rebalance_homes,
                                          rehome_blocks)
from repro_torch.fabric.replica import ReplicaSet
from repro_torch.fabric.rs import RSCodec
from repro_torch.fabric.tiers import (LOSS_TIERS, RecoveryTier,
                                     TieredRecovery)
from repro_torch.kernels import _build
from repro_torch.kernels.fused_maintain.ops import (ArenaMaintainProgram,
                                                    SpanMaintainProgram,
                                                    maintain_traffic,
                                                    make_fused_maintain_fn)
from repro_torch.kernels.parity_xor.ops import reconstruct_plan
from repro_torch.sharding.partition import block_device_homes
from repro_torch.telemetry.recorder import NULL_RECORDER, Histogram

PyTree = Any


@dataclasses.dataclass(frozen=True)
class FabricConfig:
    n_devices: int = 8
    devices_per_host: int = 2
    hosts_per_rack: int = 2
    replicate: bool = True
    replicate_interval: int = 1    # steps between replica refreshes
    parity: bool = True
    parity_group: int = 4          # members per XOR parity group
    parity_interval: int = 1       # steps between parity re-encodes
    rs_parity: int = 0             # 0 = XOR codec; m >= 1 = RS(k, m) codec
    elastic: bool = False          # post-failure re-homing/re-seeding
    fused: bool = True             # single-sweep maintenance
    arena: bool = True             # flat-arena maintenance
    async_maintain: bool = False   # two-slot pipelined sweep

    def __post_init__(self):
        if self.replicate_interval < 1 or self.parity_interval < 1:
            raise ValueError("maintenance intervals must be >= 1")
        if self.parity_group < 2:
            raise ValueError("parity_group must be >= 2: a 1-member group "
                             "degenerates the XOR code to a bare copy")
        if self.rs_parity < 0:
            raise ValueError("rs_parity must be >= 0 (0 selects the XOR "
                             "codec, m >= 1 the RS(k, m) codec)")
        if self.async_maintain and not (self.fused and self.arena):
            raise ValueError(
                "async_maintain requires the fused arena pipeline "
                "(fused=True, arena=True)")


class CheckpointFabric:
    def __init__(self, partition: BlockPartition,
                 cfg: Optional[FabricConfig] = None,
                 homes: Optional[np.ndarray] = None,
                 recorder: Optional[Any] = None,
                 mesh: Optional[Any] = None):
        self.cfg = cfg or FabricConfig()
        self.recorder = recorder if recorder is not None else NULL_RECORDER
        self.partition = partition
        self.domains = FailureDomainMap(self.cfg.n_devices,
                                        self.cfg.devices_per_host,
                                        self.cfg.hosts_per_rack)
        # the codecs pack trees into this layout for their tree-path encode
        # and decode (dtypes that are not word-packable as f32 images)
        layout = build_arena_layout(partition)
        # the single-sweep arena path needs the fused pipeline, both tiers
        # (the sweep's pack is the replica write, its XOR needs the parity
        # striping) and word-packable leaves; otherwise the per-leaf sweep
        # or the per-component passes run
        use_arena = (self.cfg.arena and self.cfg.fused and self.cfg.replicate
                     and self.cfg.parity and arena_compatible(partition))
        self.arena_layout = layout if use_arena else None
        # the mesh binding: mesh position i is logical device
        # _mesh_logical[i]; comm is this rank's collectives (None when the
        # rank is not in the mesh)
        self.mesh = None
        self.comm = None
        self._mesh_logical = None
        self._shift = 0
        self._xfer_split = (0, 0, 0)    # (local, ici, dcn) bytes a transfer
        if mesh is not None:
            from repro_torch.launch.mesh import Mesh
            if not isinstance(mesh, Mesh):
                raise TypeError(f"mesh must be a repro_torch.launch.mesh.Mesh,"
                                f" got {type(mesh).__name__}")
            n = mesh.size
            if n != self.cfg.n_devices:
                raise ValueError(
                    f"mesh has {n} devices but the fabric topology is "
                    f"configured for {self.cfg.n_devices} "
                    "(FabricConfig.n_devices must match the mesh so "
                    "failure domains map onto real devices)")
            uniform_f32 = all(l.dtype == torch.float32
                              for l in partition.leaves)
            if not (use_arena and uniform_f32) or self.cfg.rs_parity \
                    or self.cfg.async_maintain:
                raise ValueError(
                    "a meshed fabric needs the sharded arena pipeline "
                    "(arena=True, fused=True, both tiers, an all-f32 model, "
                    "the XOR codec and synchronous maintenance): there is no "
                    "sharded per-leaf, RS or async fallback")
            self.arena_layout = build_arena_layout(partition, shards=n)
        if homes is not None:
            initial = np.asarray(homes, np.int32)
        elif mesh is not None:
            # a block lives where the sharded arena places its first tile
            initial = arena_block_homes(self.arena_layout).astype(np.int32)
        else:
            initial = block_device_homes(partition, self.cfg.n_devices)
        self.view = ClusterView(self.domains, initial)
        self.replicas = (ReplicaSet(partition, self.view)
                         if self.cfg.replicate else None)
        self.parity = None
        if self.cfg.parity and self.cfg.rs_parity > 0:
            self.parity = RSCodec(partition, self.view,
                                  group_size=self.cfg.parity_group,
                                  n_parity=self.cfg.rs_parity,
                                  arena_layout=layout)
        elif self.cfg.parity:
            self.parity = ParityCodec(partition, self.view,
                                      group_size=self.cfg.parity_group,
                                      arena_layout=layout)
        self.planner = TieredRecovery(partition, self.view,
                                      replicas=self.replicas,
                                      parity=self.parity)
        if mesh is not None:
            self._bind_mesh(mesh, np.arange(mesh.size, dtype=np.int32))
        self.last_maintained_step = -1
        self._fused_fn = None
        self._fused_version = -1
        self._arena_fn = None
        self._arena_version = -1
        self._traffic = None
        self.last_scores = None
        self.last_scores_step = -1
        # True once a maintain has been fed the live arena itself: the
        # accounting then follows the resident model
        self.live_arena_mode = False
        # async maintenance: the two snapshot slots, the step whose
        # snapshot the tiers hold, and the one in-flight sweep (settled at
        # the next maintain or a consume point). On CUDA the sweep runs on
        # ``_side_stream``; ``side_stream_launches`` counts the
        # arena_maintain launches issued there.
        self._slots: list = [None, None]
        self._active_slot = 0
        self.published_epoch = -1
        self._pending: Optional[dict] = None
        self._side_stream = None
        self.side_stream_launches = 0
        self.async_hidden_seconds = 0.0
        self.async_total_seconds = 0.0
        # the deferred fences' waits
        self.fence_hist = Histogram()
        self.stats = self.recorder.scope("fabric", {
            "replica_refreshes": 0, "parity_encodes": 0,
            "recoveries": 0, "rehomes": 0, "heals": 0,
            "fused_maintains": 0, "arena_maintains": 0,
            "arena_resident_maintains": 0, "live_packs": 0,
            "async_maintains": 0, "fence_count": 0,
            "maintain_bytes_moved": 0,
            "ici_bytes_moved": 0, "dcn_bytes_moved": 0,
            "mesh_resizes": 0, "tier_fallbacks": 0,
            "rs_arena_encodes": 0, "scrubs": 0,
            "silent_errors_detected": 0, "silent_errors_corrected": 0,
            "arena_padding_ratio": 0.0})
        if self.arena_layout is not None:
            self.stats["arena_padding_ratio"] = float(
                self.arena_layout.padding_ratio)
        if self.recorder.enabled:
            self.recorder.adopt_histogram("fabric/fence_seconds",
                                          self.fence_hist)

    def attach_recorder(self, recorder: Any) -> None:
        """Late-bind a recorder (the controller's attach path for a prebuilt
        fabric). No-op if ``recorder`` is null or one is already live; the
        stats dict is registered by reference, so its readers keep
        working."""
        if recorder is None or not getattr(recorder, "enabled", False) \
                or self.recorder.enabled:
            return
        self.recorder = recorder
        self.stats = recorder.scope("fabric", self.stats)
        recorder.adopt_histogram("fabric/fence_seconds", self.fence_hist)

    # -- the mesh binding -----------------------------------------------------

    def _bind_mesh(self, mesh, logical_ids: np.ndarray) -> None:
        """Bind the fabric to ``mesh``: position ``i`` is logical device
        ``logical_ids[i]``. Picks the anti-affine replica rotation (span
        ``j``'s copy goes to position ``(j + shift) % n``: the shift with
        the most cross-host pairs, then cross-rack, in the bound topology)
        and the per-transfer local/ICI/DCN byte split of the maintain
        events (same host: ICI, another host: DCN)."""
        from repro_torch.distributed.collectives import MeshComm
        self.mesh = mesh
        self._mesh_logical = np.asarray(logical_ids, np.int32)
        n = mesh.size
        hosts = np.asarray(self.domains.host_of(self._mesh_logical))
        racks = np.asarray(self.domains.rack_of(self._mesh_logical))
        best, shift = (-1, -1), 0
        for s in range(1, n):
            dst = (np.arange(n) + s) % n
            key = (int(np.sum(hosts[dst] != hosts)),
                   int(np.sum(racks[dst] != racks)))
            if key > best:
                best, shift = key, s
        self._shift = shift
        dst = (np.arange(n) + shift) % n
        sw = self.arena_layout.shard_words * 4
        local = int(np.sum(dst == np.arange(n))) * sw
        ici = int(np.sum((hosts[dst] == hosts)
                         & (dst != np.arange(n)))) * sw
        dcn = int(np.sum(hosts[dst] != hosts)) * sw
        self._xfer_split = (local, ici, dcn)
        pos = mesh.position()
        self.comm = None if pos is None else MeshComm(mesh)
        if self.replicas is not None:
            self.replicas.bind_mesh(None if pos is None
                                    else (pos - shift) % n)

    def _replica_xfer(self, rep: torch.Tensor) -> torch.Tensor:
        """Ship this rank's replica span to its anti-affine position and
        take the span it holds in turn; books the ICI/DCN split. The
        identity without a mesh or on a one-position mesh."""
        if self.mesh is None or self._shift == 0:
            return rep
        out = self.comm.ship(rep, self._shift)
        _, ici, dcn = self._xfer_split
        self.stats["ici_bytes_moved"] += ici
        self.stats["dcn_bytes_moved"] += dcn
        return out

    def is_span(self, params: PyTree) -> bool:
        """True when ``params`` is a rank's span of the arena (the meshed
        arena-resident state)."""
        return (isinstance(params, torch.Tensor) and params.dim() == 1
                and params.dtype == torch.int32
                and params.numel() == self.arena_layout.shard_words)

    def live_span(self, params: PyTree) -> Optional[torch.Tensor]:
        """This rank's span of the live values on a mesh: ``params`` itself
        when it is the span (arena-resident state), else the span of its
        pack (a tree). None for a rank outside the mesh."""
        if self.comm is None:
            return None
        if self.is_span(params):
            return params
        w0, w1 = self.arena_layout.span(self.comm.pos)
        return pack_arena(params, self.arena_layout)[w0:w1].clone()

    def _mesh_maintain(self, step: int, params: PyTree, ckpt_values) -> None:
        """The sweep of this rank's span (:class:`SpanMaintainProgram`): the
        replica shipped anti-affine, the parity combined into the owners'
        rows, the scores summed over the mesh. A tree is packed and its
        span is the replica; the resident span gets a copy from the same
        read. A rank outside the mesh has nothing to sweep."""
        if self.comm is None:
            return
        span = self.live_span(params)
        resident = self.is_span(params)
        fn = self._arena_maintain_fn()
        rep, scores, owned = fn(span, ckpt_values, self.comm, copy=resident)
        if rep is None:
            rep = span
        self.replicas.ingest_arena(step, self._replica_xfer(rep),
                                   self.arena_layout)
        self.parity.ingest(step, owned)
        if ckpt_values is not None:
            self.last_scores = scores
            self.last_scores_step = step
        self.stats["replica_refreshes"] += 1
        self.stats["parity_encodes"] += 1
        self.stats["fused_maintains"] += 1
        self.stats["arena_maintains"] += 1
        if resident:
            self.live_arena_mode = True
            self.stats["arena_resident_maintains"] += 1
        self.stats["maintain_bytes_moved"] += self._traffic_model()[
            "arena_sharded" if resident else "arena"]
        self.published_epoch = int(step)

    def gather_tiers(self, parity: bool = True
                     ) -> tuple[Optional[torch.Tensor],
                                Optional[torch.Tensor]]:
        """The replica arena in its primary placement and (with
        ``parity``) the whole ``(n_groups, frame_elems)`` parity, gathered
        at the mesh's first position (None elsewhere): for a check of the
        sharded tiers against the plain sweep of the whole arena, never on
        a recovery."""
        comm = self.comm
        # position p holds the replica of the span of position p - shift
        rep = comm.gather(self.replicas.arena, slots=[
            (p - self._shift) % comm.n for p in range(comm.n)])
        par = (comm.gather(self.parity.parity.reshape(-1)) if parity
               else None)
        if not comm.is_root:
            return None, None
        if par is not None:
            par = par.view(-1, self.parity.layout.frame_elems)[
                :self.parity.n_groups]
        return rep, par

    def recover_span(self, live: torch.Tensor, ckpt: torch.Tensor, plan,
                     lost: np.ndarray) -> dict:
        """The tier-planned restore of this rank's span of the live arena,
        in place (:mod:`~repro_torch.fabric.span_recovery`), under ``plan``
        (``planner.plan``, made alike on every rank); ``ckpt`` is the
        rank's span of the running-checkpoint arena. Every position of the
        mesh calls it. Returns the report a single device gives, the same
        on every rank: ``full_sq``, ``partial_sq``, ``applied_sq``, the
        per-tier stats and ``tier_fallbacks``."""
        from repro_torch.fabric import span_recovery as sr
        comm, lay = self.comm, self.arena_layout
        total = self.partition.total_blocks
        tables = sr.span_tables(lay, comm.pos)
        d_ck = sr.mesh_block_sq(live, ckpt, tables, total, comm)
        before = live.clone()
        m_rep = plan.mask(RecoveryTier.PEER_REPLICA)
        m_par = plan.mask(RecoveryTier.PARITY)
        # the sweep that encoded the parity also made the replica: the
        # replica span holds the encode-time member words
        snapshot = (self.replicas.arena is not None
                    and self.replicas.refreshed_step
                    == self.parity.encoded_step)
        rep = None
        if m_rep.any() or (m_par.any() and snapshot):
            # this span's replica, from the rank that holds it
            rep = comm.ship(self.replicas.arena, -self._shift)
        if m_rep.any():
            sr.span_restore(live, rep, m_rep, tables)
        if m_par.any():
            home_alive = self.view.alive[self.view.homes]
            available = (plan.tiers < int(RecoveryTier.PARITY)) & (
                home_alive | (plan.tiers == int(RecoveryTier.PEER_REPLICA)))
            codec = self.parity
            rplan, blocks = reconstruct_plan(
                lay, codec.layout, codec.group_of, codec.members,
                np.nonzero(m_par)[0], codec.member_mask(available))
            rows_per = codec.parity.shape[0]
            g0 = comm.pos * rows_per
            sr.span_reconstruct(live, rep if snapshot else live,
                                codec.parity, rplan, blocks, lay, g0,
                                g0 + rows_per, codec.layout.frame_elems,
                                comm)
        m_ck = plan.mask(RecoveryTier.RUNNING_CKPT) \
            | plan.mask(RecoveryTier.DISK)
        if m_ck.any():
            sr.span_restore(live, ckpt, m_ck, tables)
        del rep
        d_applied = sr.mesh_block_sq(live, before, tables, total, comm)
        del before
        out = {"full_sq": float(d_ck.sum()),
               "partial_sq": float(d_ck[lost].sum()),
               "applied_sq": float(d_applied.sum())}
        out.update(self.planner.report(plan, {
            t.name: float(d_applied[plan.mask(t)].sum())
            for t in LOSS_TIERS if plan.mask(t).any()}))
        out["tier_fallbacks"] = plan.fallbacks
        return out

    def begin_failure(self, failed_devices, step: Optional[int],
                      persist_failure: Optional[bool]) -> tuple[np.ndarray,
                                                                int]:
        """The bookkeeping a failure starts with, on every rank: the
        failed devices kept dead in the view when persisted. Returns the
        failed devices and the step."""
        self._settle_pending()
        failed = np.asarray(failed_devices if failed_devices is not None
                            else [], np.int32).ravel()
        step = self.last_maintained_step if step is None else int(step)
        persist = self.cfg.elastic if persist_failure is None else \
            bool(persist_failure)
        if persist and failed.size:
            self.view.mark_failed(failed)
        return failed, step

    def end_failure(self, stats: dict, failed: np.ndarray, step: int,
                    recovered: PyTree) -> dict:
        """The bookkeeping a recovery ends with, on every rank: counters,
        fallback events and, elastic, the re-plan with the sweep of the
        recovered values."""
        self.stats["recoveries"] += 1
        stats["failed_devices"] = int(failed.size)
        stats["recovered_epoch"] = step
        stats["staleness"] = 0
        for fb in stats["tier_fallbacks"]:
            self.stats["tier_fallbacks"] += 1
            if self.recorder.enabled:
                self.recorder.event("tier_fallback", step=step, **fb)
        if self.cfg.elastic and failed.size:
            stats["placement"] = self._replan(step, recovered)
        return stats

    def resize_mesh(self, mesh, logical_ids, step: Optional[int] = None,
                    params: Optional[PyTree] = None):
        """Re-bind a meshed fabric to a shrunk (or re-grown) mesh.

        ``logical_ids[i]`` is the logical device at mesh position ``i``: the
        survivors on a shrink, the whole original range on a re-grow.
        Rebuilds the arena layout at the new shard count (the data region
        is the same, only the shard pad changes), re-homes every block to
        the shard that owns it, re-seeds the replicas, re-stripes the
        parity and drops every program built for the old shard count.
        ``params`` (this rank's span of the live arena, already moved to
        the new layout) triggers a maintain so every tier is fresh; without
        it the tiers stay stale until the caller's next maintain. Every
        rank calls it, those outside the new mesh too. Returns the new
        layout."""
        if self.mesh is None:
            raise ValueError("resize_mesh is a sharded-arena operation "
                             "(a meshed fabric only)")
        self._settle_pending()
        logical_ids = np.asarray(logical_ids, np.int32)
        new_layout = build_arena_layout(self.partition, shards=mesh.size)
        self.arena_layout = new_layout
        self._bind_mesh(mesh, logical_ids)
        self.view.homes[:] = logical_ids[arena_block_homes(new_layout)]
        self.view.version += 1
        self._arena_fn = None
        self._traffic = None
        self._slots = [None, None]
        self.replicas.reseed()
        # the old shard count's spans and rows are no tier of the new mesh
        self.replicas.ingest_arena(-1, None, None)
        self.parity.restripe()
        self.planner.rehome()
        at = int(step) if step is not None else self.last_maintained_step
        if params is not None:
            self._mesh_maintain(at, params, None)
            self.last_maintained_step = at
        self.stats["mesh_resizes"] += 1
        self.stats["arena_padding_ratio"] = float(new_layout.padding_ratio)
        if self.recorder.enabled:
            self.recorder.event(
                "mesh_resize", step=at, shards=new_layout.shards,
                alive_devices=self.view.n_alive_devices,
                alive_hosts=self.view.n_alive_hosts)
        return new_layout

    # -- maintenance ---------------------------------------------------------

    def maintain(self, step: int, params: PyTree,
                 ckpt_values: Optional[PyTree] = None,
                 force: bool = False, own_live: bool = False) -> None:
        """Refresh the redundancy tiers from live params (idempotent per
        step).

        With both tiers due, one arena sweep reads the live values once and
        yields the replica, the XOR parity and, with ``ckpt_values`` (the
        running checkpoint as an arena or a tree), per-block PRIORITY scores
        cached on ``last_scores`` for the controller's save (under RS the
        rows are then encoded from the sweep's snapshot). ``params`` may be
        the live flat arena: with ``own_live`` it becomes the replica itself
        (no copy; the caller never mutates it afterwards), without it the
        sweep writes a replica copy from the same read. Without an arena
        layout the per-leaf sweep runs instead (one fused_maintain launch
        per leaf). Off-interval steps with one tier due and a tree input,
        and ``fused=False``, run the per-component passes."""
        step = int(step)
        if step == self.last_maintained_step and not force:
            return
        live = as_live_arena(params, self.arena_layout)
        due_replica, due_parity = self.maintenance_due(step, force=force)
        b0 = self.stats["maintain_bytes_moved"]
        i0 = self.stats["ici_bytes_moved"]
        d0 = self.stats["dcn_bytes_moved"]
        if self.cfg.async_maintain and live is not None \
                and (due_replica or due_parity):
            # the pipelined path: start the sweep and return; its deferred
            # span is recorded when the epoch settles
            self._async_maintain(step, live, ckpt_values, own_live=own_live)
            self.last_maintained_step = step
            if self.recorder.enabled:
                self.recorder.event(
                    "maintain", step=step, mode="arena_async",
                    bytes_moved=self.stats["maintain_bytes_moved"] - b0,
                    ici_bytes=0, dcn_bytes=0,
                    replica=due_replica, parity=due_parity)
            return
        # a synchronous sweep rewrites the buffers an async one may still
        # be writing
        self._settle_pending()
        mode = "components"
        with self.recorder.span("maintain", step=step,
                                fence=self.block_until_maintained):
            if self.mesh is not None:
                if due_replica or due_parity:
                    self._mesh_maintain(step, params, ckpt_values)
                    mode = ("arena_resident" if self.is_span(params)
                            else "arena")
            elif self.arena_layout is not None and (
                    (due_replica and due_parity)
                    or (live is not None and (due_replica or due_parity))):
                self._arena_maintain(step, params, ckpt_values,
                                     own_live=own_live)
                mode = ("arena_resident" if live is not None
                        and not own_live else "arena")
            elif self.cfg.fused and due_replica and due_parity:
                self._fused_maintain(step, params, ckpt_values)
                mode = "fused"
            else:
                t = self._traffic_model()
                if due_replica:
                    self.replicas.refresh(step, params)
                    self.stats["replica_refreshes"] += 1
                    self.stats["maintain_bytes_moved"] += t["replica_pass"]
                if due_parity:
                    self.parity.encode(step, params)
                    self.stats["parity_encodes"] += 1
                    self.stats["maintain_bytes_moved"] += t["parity_pass"]
                if due_replica or due_parity:
                    self.published_epoch = step
        self.last_maintained_step = step
        if self.recorder.enabled:
            self.recorder.event(
                "maintain", step=step, mode=mode,
                bytes_moved=self.stats["maintain_bytes_moved"] - b0,
                ici_bytes=self.stats["ici_bytes_moved"] - i0,
                dcn_bytes=self.stats["dcn_bytes_moved"] - d0,
                replica=due_replica, parity=due_parity)

    def _arena_maintain(self, step: int, params: PyTree,
                        ckpt_values, own_live: bool = False) -> None:
        """One sweep for the whole model (a pack first when ``params`` is a
        tree: the pack is the replica write)."""
        fn = self._arena_maintain_fn()
        z = self._as_arena(ckpt_values)
        is_arena = as_live_arena(params, self.arena_layout) is not None
        owned = own_live and is_arena
        resident = is_arena and not owned
        rep, scores, parity = fn(params, z, own_live=owned)
        self.replicas.ingest_arena(step, rep, self.arena_layout)
        if self.parity.needs_arena_encode:
            # RS rows re-encode from the sweep's snapshot, the buffer the
            # replica tier stores: the arena recovery route and the scrub
            # see one coded snapshot
            self.parity.encode_from_arena(step, rep, self.arena_layout)
            self.stats["rs_arena_encodes"] += 1
        else:
            self.parity.ingest(step, parity)
        if z is not None:
            self.last_scores = scores
            self.last_scores_step = step
        self.stats["replica_refreshes"] += 1
        self.stats["parity_encodes"] += 1
        self.stats["fused_maintains"] += 1
        self.stats["arena_maintains"] += 1
        if is_arena:
            self.live_arena_mode = True
        if resident:
            self.stats["arena_resident_maintains"] += 1
        self.stats["maintain_bytes_moved"] += self._traffic_model()[
            "arena_owned" if owned else
            "arena_resident" if resident else "arena"]
        self.published_epoch = int(step)

    def _async_maintain(self, step: int, live: torch.Tensor, ckpt_values,
                        own_live: bool = False) -> None:
        """Start one pipelined sweep epoch and return without waiting.

        The pipeline is one deep: the previous epoch settles first, so the
        wait here is what the overlap failed to hide. Then the live arena
        is copied into the inactive slot (``own_live``: the caller's
        throwaway pack is adopted as the snapshot, no copy), the slot flips
        and is published, and the sweep starts against it: on CUDA on the
        side stream, after the copy, so the caller's next in-place update
        of the live arena does not wait for the sweep."""
        self._settle_pending()
        span_t0 = self.recorder.tracer.now() if self.recorder.enabled \
            else 0.0
        t0 = time.perf_counter()
        fn = self._arena_maintain_fn()
        z = self._as_arena(ckpt_values)
        if own_live:
            snap = live
        else:
            inactive = 1 - self._active_slot
            stale = self._slots[inactive]
            if stale is not None and stale.shape == live.shape \
                    and stale.dtype == live.dtype \
                    and stale.device == live.device:
                # the slot retired two epochs ago: nothing reads it now
                snap = stale.copy_(live)
            else:
                snap = live.clone()
            self._slots[inactive] = snap
            self._active_slot = inactive
        done = None
        if snap.device.type == "cuda":
            main = torch.cuda.current_stream(snap.device)
            side = self._stream(snap.device)
            side.wait_stream(main)     # the snapshot copy comes first
            with torch.cuda.stream(side):
                n0 = _build.LAUNCHES["arena_maintain"]
                _, scores, parity = fn(snap, z, own_live=True)
                self.side_stream_launches += \
                    _build.LAUNCHES["arena_maintain"] - n0
                if self.parity.needs_arena_encode:
                    self.parity.encode_from_arena(step, snap,
                                                  self.arena_layout)
                done = torch.cuda.Event()
                done.record(side)
            # the caching allocator must not hand these back while the
            # other stream may still use them
            for t in (snap, z):
                if t is not None:
                    t.record_stream(side)
            for t in (scores, parity, self.parity.parity):
                if t is not None:
                    t.record_stream(main)
        else:
            _, scores, parity = fn(snap, z, own_live=True)
            if self.parity.needs_arena_encode:
                self.parity.encode_from_arena(step, snap, self.arena_layout)
        self.replicas.ingest_arena(step, snap, self.arena_layout)
        if self.parity.needs_arena_encode:
            self.stats["rs_arena_encodes"] += 1
        else:
            self.parity.ingest(step, parity)
        if z is not None:
            self.last_scores = scores
            self.last_scores_step = step
        self.live_arena_mode = True
        self.published_epoch = int(step)
        self._pending = {"step": int(step), "t0": t0, "span_t0": span_t0,
                         "done": done}
        self.stats["replica_refreshes"] += 1
        self.stats["parity_encodes"] += 1
        self.stats["fused_maintains"] += 1
        self.stats["arena_maintains"] += 1
        self.stats["async_maintains"] += 1
        self.stats["maintain_bytes_moved"] += self._traffic_model()[
            "arena_owned" if own_live else "arena_async"]

    def _stream(self, device: torch.device):
        """The side stream of async sweeps on ``device``."""
        if self._side_stream is None or self._side_stream.device != device:
            self._side_stream = torch.cuda.Stream(device=device)
        return self._side_stream

    @property
    def has_pending_maintenance(self) -> bool:
        """True while an async sweep epoch is started but not settled."""
        return self._pending is not None

    def _settle_pending(self) -> float:
        """Fence the in-flight async sweep (no-op without one); returns the
        seconds waited. Books the epoch's hidden and total time for
        :meth:`overlap_efficiency` and records the deferred ``maintain``
        span over [dispatch, fence]."""
        p = self._pending
        if p is None:
            return 0.0
        self._pending = None
        w0 = time.perf_counter()
        if p["done"] is not None:
            p["done"].synchronize()
        now = time.perf_counter()
        wait = now - w0
        total = now - p["t0"]
        self.fence_hist.observe(wait)
        self.stats["fence_count"] += 1
        self.async_total_seconds += total
        self.async_hidden_seconds += max(0.0, total - wait)
        if self.recorder.enabled:
            self.recorder.gauge("fabric/overlap_efficiency").set(
                self.overlap_efficiency())
            self.recorder.tracer.record(
                "maintain", p["span_t0"], self.recorder.tracer.now(),
                step=p["step"], mode="arena_async", deferred=True)
        return wait

    def overlap_efficiency(self) -> float:
        """Share of the async sweeps' wall time hidden under the caller's
        work (0.0 until an async epoch has settled, and in sync mode)."""
        if self.async_total_seconds <= 0.0:
            return 0.0
        return self.async_hidden_seconds / self.async_total_seconds

    def _fused_maintain(self, step: int, params: PyTree,
                        ckpt_values: Optional[PyTree]) -> None:
        """The per-leaf sweep: one fused_maintain launch per leaf writes
        the replica leaf, the leaf's scores (against ``ckpt_values`` when
        given) and its XOR parity; under RS the rows are encoded from the
        live tree instead (the per-leaf path has no arena snapshot)."""
        fn = self._fused_maintain_fn()
        replica, scores, parity = fn(params, ckpt_values)
        self.replicas.ingest(step, replica)
        if self.parity.needs_arena_encode:
            self.parity.encode(step, params)
        else:
            self.parity.ingest(step, parity)
        if ckpt_values is not None:
            self.last_scores = scores
            self.last_scores_step = step
        self.stats["replica_refreshes"] += 1
        self.stats["parity_encodes"] += 1
        self.stats["fused_maintains"] += 1
        self.stats["maintain_bytes_moved"] += self._traffic_model()["fused"]
        self.published_epoch = int(step)

    def _fused_maintain_fn(self):
        """The per-leaf sweep program, rebuilt whenever the placement
        engine re-striped since the last build."""
        if self._fused_fn is None or self._fused_version != self.view.version:
            self._fused_fn = make_fused_maintain_fn(
                self.partition, self.parity.layout, self.parity.group_of,
                self.parity.n_groups,
                parity=not self.parity.needs_arena_encode)
            self._fused_version = self.view.version
            self._traffic = None
        return self._fused_fn

    def _as_arena(self, ckpt_values):
        """Checkpoint values in arena form (None passes through)."""
        if ckpt_values is None:
            return None
        if isinstance(ckpt_values, torch.Tensor) and ckpt_values.dim() == 1:
            want = (self.arena_layout.total_words if self.mesh is None
                    else self.arena_layout.shard_words)
            if ckpt_values.numel() != want:
                raise ValueError("checkpoint arena does not match this "
                                 "fabric's layout")
            return ckpt_values
        return pack_arena(ckpt_values, self.arena_layout)

    def _arena_maintain_fn(self) -> ArenaMaintainProgram:
        """The sweep program, rebuilt whenever the placement engine
        re-striped since the last build."""
        if self._arena_fn is None or self._arena_version != self.view.version:
            if self.mesh is not None:
                self._arena_fn = SpanMaintainProgram(
                    self.partition, self.arena_layout, self.parity.layout,
                    self.parity.group_of, self.parity.n_groups,
                    self.comm.pos, self.mesh.size)
            elif self.parity.needs_arena_encode:
                # no parity destinations: the RS codec encodes its rows
                self._arena_fn = ArenaMaintainProgram(self.partition,
                                                      self.arena_layout)
            else:
                self._arena_fn = ArenaMaintainProgram(
                    self.partition, self.arena_layout, self.parity.layout,
                    self.parity.group_of, self.parity.n_groups)
            self._arena_version = self.view.version
            self._traffic = None
        return self._arena_fn

    def block_until_maintained(self) -> None:
        """Wait for the last sweep's device work (PyTorch returns before
        the card finishes). With a pending async epoch this is the deferred
        fence: it settles the epoch."""
        if self._pending is not None:
            self._settle_pending()
            return
        for t in (None if self.parity is None else self.parity.parity,
                  None if self.replicas is None else self.replicas.arena):
            if t is not None and t.device.type == "cuda":
                torch.cuda.synchronize(t.device)
                return

    def maintenance_due(self, step: int,
                        force: bool = False) -> tuple[bool, bool]:
        """(replica due, parity due) at ``step`` under the intervals."""
        step = int(step)
        due_replica = self.replicas is not None and (
            force or step % self.cfg.replicate_interval == 0)
        due_parity = self.parity is not None and (
            force or step % self.cfg.parity_interval == 0
            or self.parity.parity is None)
        return due_replica, due_parity

    def is_fresh(self, step: int) -> bool:
        """True when every configured tier holds this step's values."""
        step = int(step)
        if self.replicas is not None and not self.replicas.is_fresh(step):
            return False
        if self.parity is not None and not self.parity.is_fresh(step):
            return False
        return True

    def invalidate_scores(self) -> None:
        """Drop the cached PRIORITY scores (a save changed the running
        checkpoint they measured against)."""
        self.last_scores = None
        self.last_scores_step = -1

    def _traffic_model(self) -> dict[str, int]:
        """Analytic bytes per maintenance step under the current striping
        (cached; placement changes invalidate)."""
        if self._traffic is None:
            model = sum(int(np.prod(l.shape) if l.shape else 1)
                        * l.dtype.itemsize for l in self.partition.leaves)
            if self.parity is not None:
                t = dict(maintain_traffic(
                    self.partition, self.parity.layout, self.parity.group_of,
                    self.parity.n_groups, self.parity.members.shape[1],
                    arena_layout=self.arena_layout))
                t["parity_pass"] = t["seed"] - 4 * t["model"]
            else:
                t = {"seed": 2 * model, "fused": 2 * model, "model": model,
                     "parity": 0, "staging_seed": 0, "staging_fused": 0,
                     "parity_pass": 0}
            t["replica_pass"] = 2 * t["model"]
            self._traffic = t
        return self._traffic

    def redundancy_state(self) -> dict:
        """Per-step health of the redundancy tiers under the current
        placement (metadata only): ``replica_alive_frac``,
        ``parity_groups_ok_frac`` and ``full`` (the next domain loss is
        sure to recover from the live-value tiers)."""
        rep_frac = par_frac = 1.0
        if self.replicas is not None:
            rep_frac = float(np.mean(
                self.view.alive[self.replicas.replica_homes]))
        if self.parity is not None:
            members = self.parity.members
            valid = members >= 0
            homes_ok = np.where(
                valid, self.view.alive[self.view.homes[
                    np.where(valid, members, 0)]], True).all(axis=1)
            ph = np.asarray(self.parity.parity_homes).reshape(
                members.shape[0], -1)
            ok = self.view.alive[ph].all(axis=1) & homes_ok
            par_frac = float(np.mean(ok)) if ok.size else 1.0
        return {"replica_alive_frac": rep_frac,
                "parity_groups_ok_frac": par_frac,
                "full": bool(rep_frac >= 1.0 and par_frac >= 1.0)}

    def redundancy_nbytes(self, store: Optional[Any] = None
                          ) -> dict[str, int]:
        """Memory of the redundancy machinery: replica and parity payloads
        (m rows per group under RS) and the parity staging, the reference's
        accounting: the arena sweep's or the per-leaf sweep's compact
        outputs, or one tree-path encode's staging when the per-component
        passes run (``fused=False`` or mismatched intervals). With a
        ``store``, its disk bytes too: ``store_disk`` (the append log and
        the parity mirror) and ``store_disk_live`` (the indexed part of the
        log and the parity)."""
        staging = 0
        if self.parity is not None:
            all_fused = (self.cfg.fused and self.cfg.replicate
                         and self.cfg.replicate_interval
                         == self.cfg.parity_interval)
            if self.live_arena_mode or (all_fused
                                        and self.arena_layout is not None):
                staging = self._traffic_model()["staging_arena"]
            elif all_fused:
                staging = self._traffic_model()["staging_fused"]
            else:
                staging = self.parity.staging_nbytes()
        out = {"replica": self.replicas.nbytes() if self.replicas else 0,
               "parity": self.parity.nbytes() if self.parity else 0,
               "parity_staging": staging}
        if store is not None and hasattr(store, "disk_nbytes"):
            disk = store.disk_nbytes()
            # "live" is the indexed subset of "shard": not additive
            out["store_disk"] = int(disk["shard"] + disk["parity"])
            out["store_disk_live"] = int(disk["live"] + disk["parity"])
        return out

    # -- failure injection ---------------------------------------------------

    def sample_domain_failure(self, rng: np.random.Generator,
                              kind: str = "host",
                              ) -> tuple[np.ndarray, np.ndarray]:
        """Correlated whole-domain loss -> (lost block mask, failed devices)."""
        failed = self.domains.sample_domain_failure(rng, kind)
        failed = failed[self.view.alive[failed]]
        return np.isin(self.view.homes, failed), failed

    def domain_failure(self, kind: str, index: int,
                       ) -> tuple[np.ndarray, np.ndarray]:
        """Loss of one specific domain under the current placement; devices
        already dead are not failed again."""
        failed = self.domains.devices_in(kind, index)
        failed = failed[self.view.alive[failed]]
        return np.isin(self.view.homes, failed), failed

    # -- recovery ------------------------------------------------------------

    def on_failure(self, params: PyTree, ckpt_values: PyTree,
                   lost_mask, failed_devices=None,
                   step: Optional[int] = None,
                   disk_values: Optional[PyTree] = None,
                   disk_reader=None,
                   persist_failure: Optional[bool] = None,
                   ) -> tuple[PyTree, dict]:
        """Tier-planned recovery. ``failed_devices=None`` is the paper's
        uniform block loss (every tier survives); ``step=None`` assumes the
        failure hit at the last maintained step. ``persist_failure``
        (default ``cfg.elastic``) keeps the failed devices dead in the view;
        with ``elastic=True`` the fabric then re-plans over the survivors.
        ``disk_reader`` (a store's ``read_blocks``) serves the DISK tier.

        A pending async epoch settles first, so every tier holds the last
        published epoch; under async maintenance a failure past that epoch
        is planned against it (a bounded perturbation, priced through
        ``recovered_epoch`` and ``staleness``)."""
        self._settle_pending()
        if failed_devices is None:
            failed_devices = np.empty((0,), np.int32)
        failed = np.asarray(failed_devices, np.int32).ravel()
        if step is None:
            step = self.last_maintained_step
        step = int(step)
        recovered_epoch, staleness = step, 0
        if self.cfg.async_maintain and 0 <= self.published_epoch < step:
            recovered_epoch = int(self.published_epoch)
            staleness = step - recovered_epoch
        persist = self.cfg.elastic if persist_failure is None else \
            bool(persist_failure)
        if persist and failed.size:
            self.view.mark_failed(failed)
        plan = self.planner.plan(lost_mask, failed, recovered_epoch)
        recovered, stats = self.planner.recover(params, ckpt_values, plan,
                                                disk_values=disk_values,
                                                disk_reader=disk_reader)
        self.stats["recoveries"] += 1
        stats["failed_devices"] = int(failed.size)
        stats["recovered_epoch"] = recovered_epoch
        stats["staleness"] = staleness
        stats["tier_fallbacks"] = plan.fallbacks
        for fb in plan.fallbacks:
            self.stats["tier_fallbacks"] += 1
            if self.recorder.enabled:
                self.recorder.event("tier_fallback", step=step, **fb)
        if self.cfg.elastic and failed.size:
            stats["placement"] = self._replan(step, recovered)
        return recovered, stats

    def _replan(self, step: int, params: PyTree) -> dict:
        """Post-failure elastic re-plan against the recovered params:
        re-home displaced blocks, re-seed replicas, re-stripe parity, and
        refresh both tiers on the new placement."""
        displaced = rehome_blocks(self.view)
        if self.mesh is not None:
            self.replicas.reseed()
            self.parity.restripe()
            self._mesh_maintain(step, params, None)
        elif self.arena_layout is not None:
            self.replicas.reseed()
            self.parity.restripe()
            self._arena_maintain(step, params, None)
        else:
            if self.replicas is not None:
                self.replicas.reseed()
                self.replicas.refresh(step, params)
                self.stats["replica_refreshes"] += 1
            if self.parity is not None:
                self.parity.restripe()
                self.parity.encode(step, params)
                self.stats["parity_encodes"] += 1
            self.published_epoch = step
        self.planner.rehome()
        self.last_maintained_step = step
        self.stats["rehomes"] += 1
        out = {"rehomed_blocks": int(displaced.size),
               "alive_devices": self.view.n_alive_devices,
               "alive_hosts": self.view.n_alive_hosts,
               "parity_groups": (self.parity.n_groups
                                 if self.parity is not None else 0)}
        if self.recorder.enabled:
            self.recorder.event("rehome", step=step, **out)
        return out

    # -- healing -------------------------------------------------------------

    def heal_domain(self, kind: str, index: int,
                    params: Optional[PyTree] = None,
                    step: Optional[int] = None) -> dict:
        """Re-admit a healed domain's devices. With ``elastic=True`` the
        placement engine rebalances primary load onto them and re-seeds /
        re-stripes the tiers (refreshed from ``params`` when given)."""
        # consume point: never re-stripe under a half-swept async epoch
        self._settle_pending()
        healed = self.view.heal(self.domains.devices_in(kind, index))
        info = {"healed_devices": int(healed.size)}
        if healed.size == 0:
            return info
        self.stats["heals"] += 1
        if not self.cfg.elastic:
            if self.recorder.enabled:
                self.recorder.event("heal", domain_kind=kind,
                                    domain_index=int(index), step=step,
                                    **info)
            return info
        at = int(step) if step is not None else self.last_maintained_step
        moved = rebalance_homes(self.view)
        if self.mesh is not None:
            self.replicas.reseed()
            self.parity.restripe()
            if params is not None:
                self._mesh_maintain(at, params, None)
        elif self.arena_layout is not None and params is not None:
            self.replicas.reseed()
            self.parity.restripe()
            self._arena_maintain(at, params, None)
        else:
            if self.replicas is not None:
                self.replicas.reseed()
                if params is not None:
                    self.replicas.refresh(at, params)
            if self.parity is not None:
                self.parity.restripe()
                if params is not None:
                    self.parity.encode(at, params)
            if params is not None:
                self.published_epoch = at
        self.planner.rehome()
        info["rebalanced_blocks"] = int(moved.size)
        info["alive_hosts"] = self.view.n_alive_hosts
        if self.recorder.enabled:
            self.recorder.event("heal", domain_kind=kind,
                                domain_index=int(index), step=step, **info)
        return info

    # -- integrity (silent errors) -------------------------------------------

    def scrub(self, step: Optional[int] = None) -> dict:
        """The integrity pass over the coded redundancy state.

        Recomputes the RS rows from the replica arena and XORs them against
        the stored rows: nonzero syndromes mean the coded snapshot was
        silently corrupted since encode. Localizable corruptions (one
        member or one stored row, m >= 2) are corrected in place by XOR-ing
        the error pattern back out; the rest are detected and reported.
        Needs the RS codec and an arena replica whose snapshot is the
        encode step's; otherwise it reports ``checked=False`` and touches
        nothing."""
        out = {"checked": False, "detected": 0, "corrected": 0,
               "reports": []}
        codec = self.parity
        if codec is None or not codec.supports_integrity:
            return out
        self._settle_pending()
        if codec.parity is None or self.replicas is None \
                or self.replicas.arena is None \
                or self.replicas.refreshed_step != codec.encoded_step:
            return out
        self.stats["scrubs"] += 1
        out["checked"] = True
        layout = self.replicas.arena_layout
        synd = codec.syndromes_from_arena(self.replicas.arena, layout)
        for rep in codec.localize_corruption(synd):
            out["detected"] += 1
            self.stats["silent_errors_detected"] += 1
            corrected = False
            if rep["localized"]:
                arena = codec.correct_in_arena(self.replicas.arena, rep,
                                               layout)
                if rep["kind"] == "member":
                    # re-ingest: drops a decoded tree form of the old bits
                    self.replicas.ingest_arena(codec.encoded_step, arena,
                                               layout)
                corrected = True
                out["corrected"] += 1
                self.stats["silent_errors_corrected"] += 1
            ev = dict(step=step, group=rep["group"], kind=rep["kind"],
                      member=rep["member"], block=rep["block"],
                      row=rep["row"], localized=rep["localized"],
                      corrected=corrected)
            out["reports"].append(ev)
            if self.recorder.enabled:
                # the bus stamps its own ``kind``: the report's is
                # ``error_kind`` there
                self.recorder.event("silent_error_detected", **{
                    ("error_kind" if k == "kind" else k): v
                    for k, v in ev.items()})
        return out

    def inject_arena_bit_flip(self, block: Optional[int] = None,
                              word: Optional[int] = None,
                              bit: Optional[int] = None,
                              rng: Optional[np.random.Generator] = None,
                              ) -> dict:
        """Fault injection: flip one bit of one block's payload in the
        replica arena, in place (the fabric's own snapshot), a silent
        corruption that only :meth:`scrub` sees. ``word`` indexes the
        block's payload words in frame-column order; whatever is not given
        is drawn from ``rng`` (default ``default_rng(0)``) in the
        reference's order. Returns where the flip landed."""
        if self.replicas is None or self.replicas.arena is None:
            raise RuntimeError("bit-flip injection needs an arena-mode "
                               "replica")
        if self.parity is None:
            raise RuntimeError("bit-flip injection needs a parity codec")
        self._settle_pending()
        layout = self.replicas.arena_layout
        if rng is None:
            rng = np.random.default_rng(0)
        if block is None:
            block = int(rng.integers(self.partition.total_blocks))
        cols, words = self.parity.arena_words_of(int(block), layout)
        k = int(word) % cols.size if word is not None \
            else int(rng.integers(cols.size))
        b = int(bit) if bit is not None else int(rng.integers(32))
        idx = int(words[k])
        arena = self.replicas.arena
        flip = int(np.array([1 << b], np.uint32).view(np.int32)[0])
        arena[idx:idx + 1] ^= torch.tensor([flip], dtype=torch.int32,
                                           device=arena.device)
        self.replicas.ingest_arena(self.replicas.refreshed_step, arena,
                                   layout)
        return {"block": int(block), "word": int(cols[k]), "bit": b,
                "arena_index": idx}

