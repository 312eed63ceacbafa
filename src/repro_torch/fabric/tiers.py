"""Tiered recovery planning: resolve each lost block to the cheapest
surviving redundancy tier and account perturbations per tier.

The port of ``repro.fabric.tiers``. Tier order (cheapest perturbation
first):

  SURVIVOR      block not lost; live value kept (SCAR partial recovery).
  PEER_REPLICA  anti-affine replica survived; restores the replica
                snapshot (the live value when fresh: zero perturbation).
  PARITY        reconstruction from the surviving group members and the
                parity: one erasure per group under XOR, up to m under
                RS(k, m) (bit-exact when fresh).
  RUNNING_CKPT  the paper's in-memory running checkpoint, homed on a host
                holding neither the primary nor the replica.
  DISK          the persistent store mirror
                (:class:`~repro_torch.checkpoint_io.ShardedCheckpointStore`,
                read only when the plan holds DISK blocks; without a store
                the running checkpoint's values stand in).
  SILENT_ERROR  not a loss tier: the integrity scrub's class for blocks
                whose coded state was silently corrupted (detected from
                the RS syndromes, corrected in place when localizable);
                never planned here.

How many erasures a group absorbs is the codec's (``code_strength``:
its parity rows homed on live devices), so one planner serves both
codecs. On CUDA tensors the PEER_REPLICA restore runs the masked_restore
kernel, PARITY the parity_xor kernel (XOR) or the gf256_mac kernel (RS),
RUNNING_CKPT and DISK ``select_blocks`` (one grouped masked_restore launch
each).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.core.blocks import (BlockPartition, leaf_word_width,
                                     masked_total, select_blocks)
from repro_torch.fabric.parity import ParityCodec, unpack_segments_into
from repro_torch.fabric.placement import ClusterView, checkpoint_cache_homes
from repro_torch.fabric.replica import ReplicaSet
from repro_torch.kernels.block_dist.ops import tree_block_scores
from repro_torch.utils.tree import tree_leaves

PyTree = Any


class RecoveryTier(enum.IntEnum):
    SURVIVOR = 0
    PEER_REPLICA = 1
    PARITY = 2
    RUNNING_CKPT = 3
    DISK = 4
    SILENT_ERROR = 5


# The reference's nominal read rate per tier, bytes/second, behind its
# ``est_recovery_seconds`` estimate. A model kept so the two packages
# report the same estimate, not a measurement of any device.
TIER_BANDWIDTH = {
    RecoveryTier.SURVIVOR: float("inf"),
    RecoveryTier.PEER_REPLICA: 50e9,
    RecoveryTier.PARITY: 200e9,
    RecoveryTier.RUNNING_CKPT: 400e9,
    RecoveryTier.DISK: 1e9,
    RecoveryTier.SILENT_ERROR: 200e9,
}

# the tiers a recovery reports on
LOSS_TIERS = tuple(t for t in RecoveryTier if t != RecoveryTier.SURVIVOR)


@dataclasses.dataclass
class TierPlan:
    tiers: np.ndarray                  # (total_blocks,) int8 RecoveryTier
    failed_devices: np.ndarray
    step: int
    # one dict per parity group whose losses exceeded the code's surviving
    # strength (ParityCodec.exceeded_groups)
    fallbacks: list = dataclasses.field(default_factory=list)

    def mask(self, tier: RecoveryTier) -> np.ndarray:
        return self.tiers == int(tier)

    @property
    def counts(self) -> dict[str, int]:
        return {t.name: int(np.sum(self.tiers == int(t)))
                for t in RecoveryTier}


class TieredRecovery:
    """Planner + executor over the fabric's redundancy tiers."""

    def __init__(self, partition: BlockPartition, view: ClusterView,
                 replicas: Optional[ReplicaSet] = None,
                 parity: Optional[ParityCodec] = None):
        self.partition = partition
        self.view = view
        self.domains = view.domains
        self.replicas = replicas
        self.parity = parity
        self.rehome()
        self._block_bytes = self._frame_bytes()

    def rehome(self) -> None:
        """Recompute the running-checkpoint cache placement from the view
        (after elastic re-homing or healing)."""
        self.ckpt_homes = checkpoint_cache_homes(
            self.view, self.replicas.replica_homes
            if self.replicas is not None else None)

    def _frame_bytes(self) -> np.ndarray:
        """Approximate payload bytes per block (for latency estimates)."""
        out = np.zeros((self.partition.total_blocks,), np.int64)
        br = self.partition.block_rows
        for leaf in self.partition.leaves:
            out[leaf.offset:leaf.offset + leaf.n_blocks] += \
                leaf_word_width(leaf, br) * 4
        return out

    # -- planning ------------------------------------------------------------

    def plan(self, lost_mask, failed_devices, step: int) -> TierPlan:
        """Resolve every block to its recovery tier for this failure."""
        lost = np.asarray(lost_mask, bool)
        failed = np.asarray(failed_devices, np.int32)
        total = self.partition.total_blocks
        tiers = np.full((total,), int(RecoveryTier.SURVIVOR), np.int8)

        replica_ok = np.zeros((total,), bool)
        replica_fresh = False
        if self.replicas is not None:
            replica_ok = lost & self.replicas.surviving(failed)
            replica_fresh = self.replicas.is_fresh(step)
        tiers[replica_ok] = int(RecoveryTier.PEER_REPLICA)

        parity_ok = np.zeros((total,), bool)
        fallbacks: list = []
        if self.parity is not None:
            # a member's frame is available if its home is alive and it is
            # not lost in this event; a fresh-replica-restored block's frame
            # equals its live value, so it serves as a survivor (cascade)
            home_alive = self.view.alive[self.view.homes]
            available = (~lost & home_alive) | (replica_ok if replica_fresh
                                                else False)
            parity_ok = self.parity.reconstructable(
                lost & ~replica_ok, available, failed, step)
            fallbacks = self.parity.exceeded_groups(
                lost & ~replica_ok, available, failed, step)
        tiers[parity_ok & ~replica_ok] = int(RecoveryTier.PARITY)

        remaining = lost & ~replica_ok & ~parity_ok
        ckpt_alive = (self.view.alive[self.ckpt_homes]
                      & ~np.isin(self.ckpt_homes, failed))
        tiers[remaining & ckpt_alive] = int(RecoveryTier.RUNNING_CKPT)
        tiers[remaining & ~ckpt_alive] = int(RecoveryTier.DISK)
        return TierPlan(tiers=tiers, failed_devices=failed, step=int(step),
                        fallbacks=fallbacks)

    # -- execution -----------------------------------------------------------

    def recover(self, params: PyTree, ckpt_values: PyTree, plan: TierPlan,
                disk_values: Optional[PyTree] = None,
                disk_reader: Optional[Callable] = None,
                ) -> tuple[PyTree, dict]:
        """Apply the plan. Returns (recovered params, per-tier stats).

        ``params`` are the pre-failure live values (kept to measure the
        perturbation each tier applies). ``disk_reader(mask)`` (a store's
        ``read_blocks``) is called only when the plan holds DISK blocks,
        with their mask; without either disk source the running
        checkpoint's values stand in for the DISK tier."""
        part = self.partition
        out = params
        device = tree_leaves(params)[0].device

        def dev_mask(m):
            return torch.from_numpy(m.copy()).to(device)

        m_rep = plan.mask(RecoveryTier.PEER_REPLICA)
        if m_rep.any():
            if self.replicas.arena is not None:
                from repro_torch.kernels.masked_restore.ops import \
                    arena_masked_restore
                out = arena_masked_restore(out, self.replicas.arena_local(),
                                           m_rep, self.replicas.arena_layout)
            else:
                out = select_blocks(out, self.replicas.values,
                                    dev_mask(m_rep), part)

        m_par = plan.mask(RecoveryTier.PARITY)
        if m_par.any():
            # survivors + replica-restored blocks carry the live words the
            # reconstruction folds against (as in plan())
            home_alive = self.view.alive[self.view.homes]
            available = (plan.tiers < int(RecoveryTier.PARITY)) & (
                home_alive | (plan.tiers == int(RecoveryTier.PEER_REPLICA)))
            if (self.replicas is not None
                    and self.replicas.arena is not None
                    and self.replicas.refreshed_step
                    == self.parity.encoded_step):
                # the sweep that encoded this parity also made the snapshot
                # arena, so the arena holds the encode-time member words
                blocks, words = self.parity.reconstruct_from_arena(
                    self.replicas.arena_local(), self.replicas.arena_layout,
                    m_par, available)
                layout = self.replicas.arena_layout
            else:
                blocks, words = self.parity.reconstruct(out, m_par, available)
                layout = self.parity.arena_layout
            out = unpack_segments_into(out, blocks, words, layout)

        m_ck = plan.mask(RecoveryTier.RUNNING_CKPT)
        if m_ck.any():
            out = select_blocks(out, ckpt_values, dev_mask(m_ck), part)

        m_dk = plan.mask(RecoveryTier.DISK)
        if m_dk.any():
            if disk_values is None and disk_reader is not None:
                disk_values = disk_reader(m_dk)
            src = disk_values if disk_values is not None else ckpt_values
            out = select_blocks(out, src, dev_mask(m_dk), part)

        # ||delta'||^2 per tier: the per-block distances once (one grouped
        # block_dist launch on the card), masked per tier, read in one copy
        hit = [t for t in LOSS_TIERS if plan.mask(t).any()]
        sums = []
        if hit:
            per_block = tree_block_scores(out, params, part)
            sums = torch.stack([masked_total(per_block,
                                             dev_mask(plan.mask(t)))
                                for t in hit]).tolist()
        return out, self.report(plan, dict(zip((t.name for t in hit), sums)))

    def report(self, plan: TierPlan, tier_sq: dict) -> dict:
        """A recovery's per-tier stats under ``plan``: the counts, ``||δ'||²``
        per tier (``tier_sq``: the tiers hit, by name; 0 for the others)
        and the latency estimates."""
        sq = dict.fromkeys((t.name for t in LOSS_TIERS), 0.0)
        sq.update(tier_sq)
        return {
            "tier_counts": plan.counts,
            "tier_sq": sq,
            "est_recovery_seconds": {t.name: float(
                self._block_bytes[plan.mask(t)].sum() / TIER_BANDWIDTH[t])
                for t in LOSS_TIERS},
        }
