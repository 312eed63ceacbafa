"""XOR parity groups over blocks with single-erasure reconstruction (tier 2).

The port of ``repro.fabric.parity``. Blocks are striped into groups of
``g`` members whose homes sit on distinct hosts, and one parity block (the
XOR of the members' bit patterns) is kept per group. A whole-host failure
then loses at most one member per group, and the lost member is rebuilt
bit-exactly as ``parity ^ XOR(surviving members)``.

Block frames: each block's payload is bit-packed into 32-bit words, one
``frame_elems``-wide int32 row per global block id, colocated leaves side
by side at their ``FrameLayout`` columns, zero-padded. Those columns equal
the arena's per-leaf columns, so the codec never builds frames: encode and
reconstruction read each member's words where they lie in the flat arena
(``kernels/parity_xor``), and a reconstruction yields the lost blocks'
arena words, which decode straight into the tree
(:func:`unpack_segments_into`). Nothing of size ``(total_blocks,
frame_elems)`` or ``(n_groups, g, frame_elems)`` is allocated;
:func:`pack_frames` / :func:`unpack_frames_into` keep the reference's
frames form for callers that hold frames (small models, tests).

A stale parity (any update since encode) is unusable, so the tier planner
gates on freshness, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.arena import (ArenaLayout, _align, build_arena_layout,
                                    pack_arena)
from repro_torch.core.blocks import (BlockPartition, decode_block_words,
                                     expand_block_mask, leaf_block_words,
                                     leaf_frame_width, leaf_word_width,
                                     words_to_elems)
from repro_torch.fabric.placement import (ClusterView, effective_parity_group,
                                          parity_group_homes,
                                          stripe_parity_groups)
from repro_torch.kernels.parity_xor.ops import (encode_plan, parity_xor,
                                                reconstruct_plan)
from repro_torch.utils.tree import tree_flatten, tree_leaves, tree_unflatten

PyTree = Any


@dataclasses.dataclass(frozen=True)
class FrameLayout:
    """Column placement of each leaf's payload inside its blocks' frames
    (starts and total width aligned to the arena tile)."""
    cols: tuple[int, ...]      # per-leaf start column (tile-aligned)
    widths: tuple[int, ...]    # per-leaf payload width (words)
    frame_elems: int           # int32 words per frame (tile-aligned)


def frame_layout(partition: BlockPartition) -> FrameLayout:
    cols, widths = [], []
    used: dict[int, int] = {}  # block-id offset -> columns consumed so far
    for leaf in partition.leaves:
        w = leaf_word_width(leaf, partition.block_rows)
        start = used.get(leaf.offset, 0)   # colocated leaves share offsets
        cols.append(start)
        widths.append(w)
        used[leaf.offset] = start + _align(w)
    return FrameLayout(tuple(cols), tuple(widths),
                       _align(max(used.values())))


def pack_frames(values: PyTree, partition: BlockPartition,
                layout: FrameLayout) -> torch.Tensor:
    """(total_blocks, frame_elems) int32 frames of a tree (the reference's
    form; the codec itself never builds them)."""
    leaves = tree_leaves(values)
    out = torch.zeros((partition.total_blocks, layout.frame_elems),
                      dtype=torch.int32, device=leaves[0].device)
    for x, leaf, col, w in zip(leaves, partition.leaves, layout.cols,
                               layout.widths):
        out[leaf.offset:leaf.offset + leaf.n_blocks, col:col + w] = \
            leaf_block_words(x, partition.block_rows)
    return out


def unpack_frames_into(dst: PyTree, frames_by_block: torch.Tensor,
                       block_mask: np.ndarray, partition: BlockPartition,
                       layout: FrameLayout) -> PyTree:
    """Overwrite the masked blocks of ``dst`` with values decoded from
    ``frames_by_block`` (the reference's form); other blocks pass through."""
    mask = np.asarray(block_mask, bool)
    flat, treedef = tree_flatten(dst)
    out = []
    for x, leaf, col, w in zip(flat, partition.leaves, layout.cols,
                               layout.widths):
        seg = mask[leaf.offset:leaf.offset + leaf.n_blocks]
        if not seg.any():
            out.append(x)
            continue
        bits = frames_by_block[leaf.offset:leaf.offset + leaf.n_blocks,
                               col:col + w]
        decoded = decode_block_words(bits, leaf, partition.block_rows)
        em = expand_block_mask(torch.from_numpy(seg.copy()).to(x.device),
                               leaf, partition.block_rows)
        out.append(torch.where(em, decoded.to(x.dtype), x))
    return tree_unflatten(treedef, out)


def unpack_segments_into(dst: PyTree, blocks: np.ndarray,
                         words: torch.Tensor,
                         arena_layout: ArenaLayout) -> PyTree:
    """Decode the payload words of arena blocks ``blocks`` (back to back in
    ``words``, in that order) into their rows of ``dst``. Leaves without
    such a block pass through as the same tensors; touched leaves are new
    tensors."""
    part = arena_layout.partition
    br = part.block_rows
    ab = arena_layout.ab_arrays()
    blocks = np.asarray(blocks, np.int64)
    pay = ab["payload"][blocks]
    starts = np.cumsum(pay) - pay
    flat, treedef = tree_flatten(dst)
    out = list(flat)
    dev = words.device
    for li in np.unique(ab["leaf"][blocks]):
        leaf = part.leaves[int(li)]
        sel = ab["leaf"][blocks] == li
        n, pw = int(sel.sum()), arena_layout.payload_words[int(li)]
        # the gather and row indices are built on the device: on the host
        # they would be n x payload int64s to upload
        idx = torch.from_numpy(starts[sel]).to(dev)[:, None] \
            + torch.arange(pw, device=dev)
        elems = leaf_frame_width(leaf, br)
        rw = max(leaf.row_width, 1)
        per = elems // rw                      # rows per block's payload
        vals = words_to_elems(words[idx], leaf.dtype, elems).reshape(n, per,
                                                                    rw)
        b = torch.from_numpy(ab["gid"][blocks][sel] - leaf.offset).to(dev)
        rows = b[:, None] * br + torch.arange(per, device=dev)
        ok = rows < max(leaf.rows, 1)
        x = flat[int(li)]
        new = x.reshape(-1, rw).clone()
        new[rows[ok]] = vals[ok].to(x.dtype)
        out[int(li)] = new.reshape(leaf.shape)
    return tree_unflatten(treedef, out)


class ParityCodec:
    """XOR parity over anti-affine block groups, read from the flat arena.

    Group striping and parity homing are read from the fabric's mutable
    :class:`~repro_torch.fabric.placement.ClusterView`; after a domain loss
    :meth:`restripe` re-cuts the groups over the surviving hosts and
    invalidates the parity until the next encode. ``arena_layout`` is the
    layout the tree-path encode and reconstruction pack into (built from
    the partition when not given).
    """

    n_parity = 1
    needs_arena_encode = False
    supports_integrity = False

    def __init__(self, partition: BlockPartition, view: ClusterView,
                 group_size: int = 4,
                 arena_layout: Optional[ArenaLayout] = None):
        if group_size < 2:
            raise ValueError("parity group_size must be >= 2")
        self.partition = partition
        self.view = view
        self.domains = view.domains
        self.requested_group_size = group_size
        self.layout = frame_layout(partition)
        self.arena_layout = (arena_layout if arena_layout is not None
                             else build_arena_layout(partition))
        self.parity: Optional[torch.Tensor] = None
        self.encoded_step = -1
        self._build()

    def _build(self) -> None:
        """(Re)derive groups and parity homes from the view's placement."""
        self._stripe()
        self.parity_homes = parity_group_homes(self.members, self.view)
        self._encode_plan = None

    def _stripe(self) -> None:
        self.group_size = effective_parity_group(self.view,
                                                 self.requested_group_size,
                                                 reserve=self.n_parity)
        self.members = stripe_parity_groups(self.view, self.group_size,
                                            fold_tail=self.n_parity < 2)
        self.n_groups = self.members.shape[0]
        self.valid = self.members >= 0
        self.group_of = np.full((self.partition.total_blocks,), -1, np.int32)
        rows = np.broadcast_to(np.arange(self.n_groups)[:, None],
                               self.members.shape)
        self.group_of[self.members[self.valid]] = rows[self.valid]
        # -1 members index row 0 but are masked out by ``valid``
        self._gather_ids = np.where(self.valid, self.members, 0)

    def member_mask(self, block_mask: np.ndarray) -> np.ndarray:
        """(n_groups, width) bool: the member slots whose blocks the
        (total_blocks,) ``block_mask`` holds (padding slots False)."""
        return self.valid & np.asarray(block_mask, bool)[self._gather_ids]

    # -- maintenance ---------------------------------------------------------

    def encode_arena(self, arena: torch.Tensor) -> torch.Tensor:
        """(n_groups, frame_elems) parity of a packed arena (one parity_xor
        launch on the card)."""
        if self._encode_plan is None:
            self._encode_plan = encode_plan(self.arena_layout, self.layout,
                                            self.members)
        fe = self.layout.frame_elems
        out = torch.empty((self.n_groups * fe,), dtype=torch.int32,
                          device=arena.device)
        return parity_xor(out, arena, None, self._encode_plan) \
            .view(self.n_groups, fe)

    def encode(self, step: int, values: PyTree) -> None:
        """Re-encode every parity block from live values (a tree)."""
        self.parity = self.encode_arena(pack_arena(values, self.arena_layout))
        self.encoded_step = int(step)

    def ingest(self, step: int, parity: torch.Tensor) -> None:
        """Adopt a parity encoded elsewhere (the arena sweep writes it)."""
        self.parity = parity
        self.encoded_step = int(step)

    def restripe(self) -> None:
        """Re-cut the groups over the view's current topology; the parity
        is invalid until the next encode."""
        self._build()
        self.parity = None
        self.encoded_step = -1

    def is_fresh(self, step: int) -> bool:
        return self.parity is not None and self.encoded_step == int(step)

    def nbytes(self) -> int:
        return 0 if self.parity is None else self.parity.numel() * 4

    def staging_nbytes(self) -> int:
        """Peak staging of one tree-path :meth:`encode`: the packed arena
        (the reference's frames and member gather do not exist here)."""
        return self.arena_layout.nbytes

    def arena_words_of(self, block: int,
                       arena_layout: Optional[ArenaLayout] = None
                       ) -> tuple[np.ndarray, np.ndarray]:
        """``(frame columns, arena words)`` of a block's payload, column by
        column in ascending order: its arena segments at their frame
        columns."""
        lay = arena_layout or self.arena_layout
        cols, words = [], []
        for a in lay.gid_ab[lay.gid_ptr[block]:lay.gid_ptr[block + 1]]:
            ab = lay.blocks[a]
            col = self.layout.cols[ab.leaf]
            cols.append(np.arange(col, col + ab.payload))
            words.append(np.arange(ab.offset, ab.offset + ab.payload))
        if not cols:
            return np.empty((0,), np.int64), np.empty((0,), np.int64)
        cols, words = np.concatenate(cols), np.concatenate(words)
        order = np.argsort(cols, kind="stable")
        return cols[order], words[order]

    # -- recovery ------------------------------------------------------------

    def code_strength(self, failed_devices) -> np.ndarray:
        """(n_groups,) erasures each group can absorb right now: its parity
        rows homed on devices alive and outside the failing set."""
        failed = np.asarray(failed_devices, np.int32)
        homes = np.asarray(self.parity_homes).reshape(self.n_groups, -1)
        ok = self.view.alive[homes] & ~np.isin(homes, failed)
        return ok.sum(axis=1).astype(np.int64)

    def reconstructable(self, lost_mask: np.ndarray,
                        available_mask: np.ndarray,
                        failed_devices, step: int) -> np.ndarray:
        """(total_blocks,) bool: lost blocks recoverable from parity (fresh
        parity, and the group's erasures within its surviving strength)."""
        total = self.partition.total_blocks
        if not self.is_fresh(step):
            return np.zeros((total,), bool)
        lost = np.asarray(lost_mask, bool)
        available = np.asarray(available_mask, bool)
        member_unavail = self.member_mask(~available)
        erased = member_unavail.sum(axis=1)
        strength = self.code_strength(failed_devices)
        ok_group = (erased >= 1) & (erased <= strength)
        out = np.zeros((total,), bool)
        out[self.members[ok_group[:, None] & member_unavail]] = True
        return out & lost

    def exceeded_groups(self, lost_mask: np.ndarray,
                        available_mask: np.ndarray,
                        failed_devices, step: int) -> list[dict]:
        """Groups holding lost blocks the code cannot recover (erasures over
        the surviving strength, or a stale parity), one dict each."""
        lost = np.asarray(lost_mask, bool)
        available = np.asarray(available_mask, bool)
        member_lost = self.member_mask(lost)
        erased = self.member_mask(~available).sum(axis=1)
        fresh = self.is_fresh(step)
        strength = self.code_strength(failed_devices) if fresh \
            else np.zeros((self.n_groups,), np.int64)
        bad = member_lost.any(axis=1) & (erased > strength)
        return [dict(group=int(j), lost_members=int(member_lost[j].sum()),
                     unavailable=int(erased[j]), strength=int(strength[j]),
                     fresh=bool(fresh))
                for j in np.nonzero(bad)[0]]

    def reconstruct(self, values: PyTree, recover_mask: np.ndarray,
                    available_mask: np.ndarray):
        """:meth:`reconstruct_from_arena` over a pack of ``values``, which
        must hold live words for every available member."""
        return self.reconstruct_from_arena(
            pack_arena(values, self.arena_layout), self.arena_layout,
            recover_mask, available_mask)

    def reconstruct_from_arena(self, arena: torch.Tensor,
                               arena_layout: ArenaLayout,
                               recover_mask: np.ndarray,
                               available_mask: np.ndarray):
        """Rebuild the blocks of ``recover_mask`` from the parity and the
        available members' words in ``arena`` (the encode-time snapshot).
        Returns ``(blocks, words)``: the recovered arena blocks and their
        payload words back to back (:func:`unpack_segments_into` decodes
        them)."""
        if self.parity is None:
            raise RuntimeError("no parity to reconstruct from")
        keep = self.member_mask(available_mask)
        plan, blocks = reconstruct_plan(
            arena_layout, self.layout, self.group_of, self.members,
            np.nonzero(np.asarray(recover_mask, bool))[0], keep)
        out = torch.empty((plan.out_words,), dtype=torch.int32,
                          device=arena.device)
        parity_xor(out, arena, self.parity.reshape(-1), plan)
        return blocks, out
