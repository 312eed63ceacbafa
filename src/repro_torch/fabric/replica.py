"""Anti-affine peer replication of running-state blocks (tier 1).

The port of ``repro.fabric.replica``. Each block's replica is placed in a
different failure domain (the farthest the current topology offers), so a
whole-domain failure never takes a block and its replica together.
Placement is read from the fabric's :class:`ClusterView` and re-seeded
after a domain loss. A replica restored while fresh is the block's live
value: zero perturbation in the Theorem 4.1 accounting.

The snapshot is a tree (the per-component refresh or the per-leaf sweep's
copy) or a flat arena ingested by the arena sweep (the hot-path form);
``values`` decodes the arena on demand (recovery only).

On a mesh the replica is placed anti-affine by span: the rank at position
``p`` holds the replica of the span of position ``held_span`` (``(p -
shift) % n``, the fabric's rotation), as the reference's
``main_sharding`` and its rolled replica sharding place it (the
fabric's ``_bind_mesh`` sets it through ``bind_mesh``). A recovery ships
each span's replica back to its owner
(:meth:`~repro_torch.fabric.fabric.CheckpointFabric.recover_span`).
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.blocks import BlockPartition
from repro_torch.core.checkpoint import clone_tree
from repro_torch.fabric.placement import ClusterView, anti_affine_replica_homes
from repro_torch.utils.tree import tree_leaves

PyTree = Any


class ReplicaSet:
    """One replica per block, anti-affine to the block's primary home."""

    def __init__(self, partition: BlockPartition, view: ClusterView):
        self.partition = partition
        self.view = view
        self.domains = view.domains
        self.replica_homes = anti_affine_replica_homes(view)
        self._tree: Optional[PyTree] = None
        self._arena: Optional[torch.Tensor] = None
        self._held: Optional[int] = None    # the span held, on a mesh
        self.arena_layout = None
        self.refreshed_step = -1

    def bind_mesh(self, held_span: Optional[int]) -> None:
        """On a mesh: the position whose span this rank's replica holds
        (None: a rank outside the mesh, or no mesh)."""
        self._held = held_span


    # -- maintenance ---------------------------------------------------------

    def refresh(self, step: int, params: PyTree) -> None:
        """Snapshot live params into the replicas (a device copy)."""
        self._tree = clone_tree(params)
        self._arena = None
        self.refreshed_step = int(step)

    def ingest(self, step: int, values: PyTree) -> None:
        """Adopt a tree snapshot made elsewhere (the per-leaf sweep writes
        the replica copy in the pass that folds the parity)."""
        self._tree = values
        self._arena = None
        self.refreshed_step = int(step)

    def ingest_arena(self, step: int, arena: torch.Tensor,
                     arena_layout) -> None:
        """Adopt an arena snapshot (the sweep's pack or copy is the replica
        write); the tree form is decoded lazily, on the recovery path.

        Under async maintenance this call is the publish: the fabric's
        snapshot slot becomes the replica here, together with the parity
        ingest of the same step, so a reader never sees replica and
        parity of different epochs. The slot may still be read by the
        sweep on the side stream; readers fence through
        ``fabric.block_until_maintained`` first."""
        self._arena = arena
        self.arena_layout = arena_layout
        self._tree = None
        self.refreshed_step = int(step)

    @property
    def arena(self) -> Optional[torch.Tensor]:
        """The arena snapshot, or None when tree-form (or empty)."""
        return self._arena

    def arena_local(self) -> Optional[torch.Tensor]:
        """The arena snapshot on the primary placement: the identity
        without a mesh. On a mesh the rank holds another rank's span, and
        the span's owner reads it shipped back: this raises."""
        if self._held is not None:
            raise ValueError("on a mesh this rank holds the replica of span "
                             f"{self._held}; its owner recovers from it "
                             "shipped back (CheckpointFabric.recover_span)")
        return self._arena

    @property
    def values(self) -> Optional[PyTree]:
        """Tree-form snapshot; decodes the arena on first access."""
        if self._tree is None and self._arena is not None:
            from repro_torch.core.arena import unpack_arena
            self._tree = unpack_arena(self._arena, self.arena_layout)
        return self._tree

    def is_fresh(self, step: int) -> bool:
        """True when the replicas hold the current live values."""
        return (self._tree is not None or self._arena is not None) \
            and self.refreshed_step == int(step)

    def staleness(self, step: int) -> int:
        """Steps between ``step`` and the snapshot the replicas hold (0:
        fresh; -1: no snapshot): how a recovery from the async pipeline's
        published epoch is priced."""
        if self._tree is None and self._arena is None:
            return -1
        return max(0, int(step) - self.refreshed_step)

    def reseed(self) -> None:
        """Recompute replica placement in the view's current topology;
        values are untouched until the next refresh."""
        self.replica_homes = anti_affine_replica_homes(self.view)

    # -- survivorship --------------------------------------------------------

    def surviving(self, failed_devices) -> np.ndarray:
        """(total_blocks,) bool: replicas whose home is alive in the view
        and not among this event's failed devices."""
        if self._tree is None and self._arena is None:
            return np.zeros((self.partition.total_blocks,), bool)
        failed = np.asarray(failed_devices, np.int32)
        return (self.view.alive[self.replica_homes]
                & ~np.isin(self.replica_homes, failed))

    def nbytes(self) -> int:
        if self._arena is not None:
            return self._arena.numel() * 4
        if self._tree is None:
            return 0
        return sum(x.numel() * x.element_size()
                   for x in tree_leaves(self._tree))
