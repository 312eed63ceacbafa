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
                                  (``inject_arena_bit_flip`` makes one).

Three maintenance paths, as in the reference: the arena sweep (the
default), the per-leaf sweep (``arena=False``, and every tree with a dtype
the arena cannot pack: f64, int64, bool, complex), and the per-component
passes (``fused=False``, one-tier fabrics, off-interval steps). The codec
is XOR parity (``rs_parity=0``) or RS(k, m) (``rs_parity=m``), which
re-encodes its rows from the sweep's snapshot.

The failure domains are logical: ``FabricConfig()``'s 8 devices, 4 hosts
and 2 racks are bookkeeping over the one device the tensors live on.

Not ported yet, and raising ``NotImplementedError`` with their ROADMAP
item: ``async_maintain=True`` (item 12), ``mesh=`` and ``resize_mesh``
(item 15). The reference's ``use_pallas`` option is gone: each kernel runs
on CUDA tensors and its plain version on CPU tensors. Telemetry events
come with the full recorder (item 9).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.arena import (arena_compatible, as_live_arena,
                                    build_arena_layout, pack_arena)
from repro_torch.core.blocks import BlockPartition
from repro_torch.fabric.domains import FailureDomainMap
from repro_torch.fabric.parity import ParityCodec
from repro_torch.fabric.placement import (ClusterView, rebalance_homes,
                                          rehome_blocks)
from repro_torch.fabric.replica import ReplicaSet
from repro_torch.fabric.rs import RSCodec
from repro_torch.fabric.tiers import TieredRecovery
from repro_torch.kernels.fused_maintain.ops import (ArenaMaintainProgram,
                                                    maintain_traffic,
                                                    make_fused_maintain_fn)
from repro_torch.sharding.partition import block_device_homes
from repro_torch.telemetry.recorder import NULL_RECORDER

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
    async_maintain: bool = False   # ROADMAP item 12

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
        if mesh is not None:
            raise NotImplementedError(
                "the sharded arena and the elastic mesh are not ported yet "
                "(ROADMAP item 15)")
        if self.cfg.async_maintain:
            raise NotImplementedError(
                "async maintenance is not ported yet (ROADMAP item 12)")
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
        initial = (np.asarray(homes, np.int32) if homes is not None
                   else block_device_homes(partition, self.cfg.n_devices))
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
        if self.arena_layout is not None and (
                (due_replica and due_parity)
                or (live is not None and (due_replica or due_parity))):
            self._arena_maintain(step, params, ckpt_values,
                                 own_live=own_live)
        elif self.cfg.fused and due_replica and due_parity:
            self._fused_maintain(step, params, ckpt_values)
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
        self.last_maintained_step = step

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
            if ckpt_values.numel() != self.arena_layout.total_words:
                raise ValueError("checkpoint arena does not match this "
                                 "fabric's layout")
            return ckpt_values
        return pack_arena(ckpt_values, self.arena_layout)

    def _arena_maintain_fn(self) -> ArenaMaintainProgram:
        """The sweep program, rebuilt whenever the placement engine
        re-striped since the last build."""
        if self._arena_fn is None or self._arena_version != self.view.version:
            if self.parity.needs_arena_encode:
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
        the card finishes)."""
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

    def redundancy_nbytes(self) -> dict[str, int]:
        """Memory of the redundancy machinery: replica and parity payloads
        (m rows per group under RS) and the parity staging, the reference's
        accounting: the arena sweep's or the per-leaf sweep's compact
        outputs, or one tree-path encode's staging when the per-component
        passes run (``fused=False`` or mismatched intervals)."""
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
        return {"replica": self.replicas.nbytes() if self.replicas else 0,
                "parity": self.parity.nbytes() if self.parity else 0,
                "parity_staging": staging}

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
                   persist_failure: Optional[bool] = None,
                   ) -> tuple[PyTree, dict]:
        """Tier-planned recovery. ``failed_devices=None`` is the paper's
        uniform block loss (every tier survives); ``step=None`` assumes the
        failure hit at the last maintained step. ``persist_failure``
        (default ``cfg.elastic``) keeps the failed devices dead in the view;
        with ``elastic=True`` the fabric then re-plans over the survivors."""
        if failed_devices is None:
            failed_devices = np.empty((0,), np.int32)
        failed = np.asarray(failed_devices, np.int32).ravel()
        if step is None:
            step = self.last_maintained_step
        step = int(step)
        persist = self.cfg.elastic if persist_failure is None else \
            bool(persist_failure)
        if persist and failed.size:
            self.view.mark_failed(failed)
        plan = self.planner.plan(lost_mask, failed, step)
        recovered, stats = self.planner.recover(params, ckpt_values, plan,
                                                disk_values=disk_values)
        self.stats["recoveries"] += 1
        stats["failed_devices"] = int(failed.size)
        stats["recovered_epoch"] = step
        stats["staleness"] = 0
        stats["tier_fallbacks"] = plan.fallbacks
        self.stats["tier_fallbacks"] += len(plan.fallbacks)
        if self.cfg.elastic and failed.size:
            stats["placement"] = self._replan(step, recovered)
        return recovered, stats

    def _replan(self, step: int, params: PyTree) -> dict:
        """Post-failure elastic re-plan against the recovered params:
        re-home displaced blocks, re-seed replicas, re-stripe parity, and
        refresh both tiers on the new placement."""
        displaced = rehome_blocks(self.view)
        if self.arena_layout is not None:
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
        self.planner.rehome()
        self.last_maintained_step = step
        self.stats["rehomes"] += 1
        return {"rehomed_blocks": int(displaced.size),
                "alive_devices": self.view.n_alive_devices,
                "alive_hosts": self.view.n_alive_hosts,
                "parity_groups": (self.parity.n_groups
                                  if self.parity is not None else 0)}

    # -- healing -------------------------------------------------------------

    def heal_domain(self, kind: str, index: int,
                    params: Optional[PyTree] = None,
                    step: Optional[int] = None) -> dict:
        """Re-admit a healed domain's devices. With ``elastic=True`` the
        placement engine rebalances primary load onto them and re-seeds /
        re-stripes the tiers (refreshed from ``params`` when given)."""
        healed = self.view.heal(self.domains.devices_in(kind, index))
        info = {"healed_devices": int(healed.size)}
        if healed.size == 0:
            return info
        self.stats["heals"] += 1
        if not self.cfg.elastic:
            return info
        at = int(step) if step is not None else self.last_maintained_step
        moved = rebalance_homes(self.view)
        if self.arena_layout is not None and params is not None:
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
        self.planner.rehome()
        info["rebalanced_blocks"] = int(moved.size)
        info["alive_hosts"] = self.view.n_alive_hosts
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
            out["reports"].append(dict(
                step=step, group=rep["group"], kind=rep["kind"],
                member=rep["member"], block=rep["block"], row=rep["row"],
                localized=rep["localized"], corrected=corrected))
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

    # -- not ported yet ------------------------------------------------------

    def resize_mesh(self, *args, **kwargs):
        raise NotImplementedError(
            "the elastic mesh is not ported yet (ROADMAP item 15)")
