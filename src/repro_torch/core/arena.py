"""Flat parameter arena: one contiguous buffer of 32-bit words for all leaves.

The port of ``repro.core.arena``, in the reference's data format, so the
two packages' arenas compare byte for byte:

- every leaf's payload is bit-packed ``dtype_word_ratio`` elements per
  word (:func:`repro_torch.core.blocks.leaf_block_words`); f32 leaves are
  stored bitwise as their values. The port carries the words as
  ``torch.int32`` (the reference as float32);
- **main region**: multi-block leaves and leaves of at least a tile, laid
  out block-major in flatten order, each block zero-padded to a multiple
  of ``ARENA_TILE`` = 8 x 128 words, so every block covers whole tiles;
- **tail region**: single-block leaves narrower than a tile, packed back
  to back at word granularity after the main region (they share tiles);
  the region end is re-aligned so ``total_words`` is a tile multiple;
- the **block table** maps ``(leaf, block) -> (offset, words, payload)``;
  ``[payload, words)`` is zero padding (XOR-neutral for parity,
  diff-neutral for scores);
- per-leaf arena columns equal the parity ``FrameLayout`` columns, so an
  XOR over arena words lands bit-exactly in the codec's
  ``(n_groups, frame_elems)`` parity.

Invariants (the reference's I1-I4, without the mesh's shard pad): main
offsets and words are tile multiples and tail blocks are word-contiguous;
segments are disjoint and cover ``[0, total_words)`` except the zero
tail-alignment gap; ``unpack(pack(tree)) == tree`` bit for bit; pad words
are zero after ``pack`` and every arena mutation keeps them zero.

Routing tables are **per tile** for the main region (``tile_gids``,
``tile_codes``) and per word only for the tail region (``tail_tables``):
a per-word table of a 1.5 B-value model would hold 1.5 B host entries.
The value domain (``pack_values``/``decode_values``/``encode_values``,
the LM trainer's optimizer seam) and the mesh (``relayout_*``,
``arena_block_homes``, ``out_sharding``) are not ported here.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.blocks import (WORD_DTYPE_NAMES, BlockPartition,
                                     decode_block_words, leaf_block_words,
                                     leaf_word_width, word_packable)
from repro_torch.utils.tree import tree_leaves, tree_unflatten

PyTree = Any

ARENA_LANES = 128          # lane width of the reference's 2D retiling
ARENA_SUBLANES = 8         # its f32 sublane tile height
ARENA_TILE = ARENA_LANES * ARENA_SUBLANES   # words per tile


def _align(n: int, a: int = ARENA_TILE) -> int:
    return -(-max(int(n), 1) // a) * a


def dtype_code(dtype: torch.dtype) -> int:
    """The arena's dtype code of a leaf dtype: its index in
    ``WORD_DTYPE_NAMES`` (0 = f32, also for dtypes that are not
    word-packable, which keep the f32-image convention)."""
    if not word_packable(dtype):
        return 0
    return WORD_DTYPE_NAMES.index(str(dtype).removeprefix("torch."))


def arena_compatible(partition: BlockPartition) -> bool:
    """True when every leaf dtype is word-packable. Trees with f64, int64,
    complex or bool leaves take the per-leaf path."""
    return all(word_packable(l.dtype) for l in partition.leaves)


@dataclasses.dataclass(frozen=True)
class ArenaBlock:
    """One block-table row: where block ``b`` of leaf ``leaf`` lives."""
    leaf: int          # leaf index in flatten order
    gid: int           # global block id (colocated leaves share gids)
    offset: int        # word offset of the segment (tile-aligned unless tail)
    words: int         # segment length (== payload for tail blocks)
    payload: int       # live words; [payload, words) is zero padding


@dataclasses.dataclass(frozen=True, eq=False)
class ArenaLayout:
    """Static block table of one partition.

    ``ab_t0``/``ab_nt`` (first tile and touched-tile count per arena block)
    and the gid -> arena-block CSR (``gid_ab``/``gid_ptr``) keep the
    per-save lookups O(selected). ``eq=False``: identity comparison, as in
    the reference (the numpy tables make a generated ``__eq__``
    ill-defined)."""
    partition: BlockPartition
    blocks: tuple[ArenaBlock, ...]      # offset-ascending
    leaf_offset: tuple[int, ...]        # word offset of each leaf's segment
    seg_words: tuple[int, ...]          # segment words per block, per leaf
    payload_words: tuple[int, ...]      # live words per block, per leaf
    total_words: int                    # ARENA_TILE multiple
    ab_t0: np.ndarray                   # (n_ab,) first tile per arena block
    ab_nt: np.ndarray                   # (n_ab,) touched tiles per arena block
    gid_ab: np.ndarray                  # arena blocks sorted by gid (CSR)
    gid_ptr: np.ndarray                 # (total_blocks + 1,) CSR pointers
    tail_start: int                     # word offset of the tail region
    leaf_order: tuple[int, ...]         # leaf indices in offset order

    @property
    def n_tiles(self) -> int:
        return self.total_words // ARENA_TILE

    @property
    def nbytes(self) -> int:
        return self.total_words * 4

    @property
    def has_tail(self) -> bool:
        return self.tail_start < self.total_words

    @property
    def padding_ratio(self) -> float:
        """Pad words / live payload words over the whole buffer."""
        data = int(self.ab_arrays()["payload"].sum())
        return (self.total_words - data) / max(data, 1)

    def ab_arrays(self) -> dict[str, np.ndarray]:
        """Cached columns of the block table as int64 arrays: ``leaf``,
        ``gid``, ``offset``, ``words``, ``payload``."""
        cached = getattr(self, "_ab_arrays", None)
        if cached is None:
            cached = {f: np.asarray([getattr(ab, f) for ab in self.blocks],
                                    np.int64)
                      for f in ("leaf", "gid", "offset", "words", "payload")}
            object.__setattr__(self, "_ab_arrays", cached)
        return cached

    # -- per-tile and tail tables --------------------------------------------

    def main_tiles(self) -> tuple[np.ndarray, np.ndarray]:
        """``(tiles, blocks)``: every main-region tile, ascending, and the
        arena block that owns it."""
        ab = self.ab_arrays()
        main = np.nonzero(ab["offset"] < self.tail_start)[0]
        nt = ab["words"][main] // ARENA_TILE
        starts = np.cumsum(nt) - nt
        tiles = (np.repeat(ab["offset"][main] // ARENA_TILE, nt)
                 + np.arange(int(nt.sum())) - np.repeat(starts, nt))
        return tiles, np.repeat(main, nt)

    def tile_gids(self) -> np.ndarray:
        """(n_tiles,) int32 gid owning each main-region tile. Tail-region
        tiles report -1: several blocks may share them, so per-gid
        reductions use :meth:`tail_tables` there."""
        gids = np.full((self.n_tiles,), -1, np.int32)
        tiles, abi = self.main_tiles()
        gids[tiles] = self.ab_arrays()["gid"][abi]
        return gids

    def tile_codes(self) -> np.ndarray:
        """(n_tiles,) int8 dtype code (:func:`dtype_code`) of each
        main-region tile; tail-region tiles report 0."""
        cached = getattr(self, "_tile_codes", None)
        if cached is None:
            leaf_code = np.asarray([dtype_code(l.dtype)
                                    for l in self.partition.leaves], np.int8)
            cached = np.zeros((self.n_tiles,), np.int8)
            tiles, abi = self.main_tiles()
            cached[tiles] = leaf_code[self.ab_arrays()["leaf"][abi]]
            object.__setattr__(self, "_tile_codes", cached)
        return cached

    def tail_tables(self) -> tuple[np.ndarray, np.ndarray]:
        """``(word_gid, word_code)`` for the tail region's words
        ``[tail_start, total_words)`` only: the gid and dtype code of each
        word (alignment-gap words report gid 0, code 0; their zero words
        add an exact +0.0 to any reduction)."""
        n = self.total_words - self.tail_start
        gid = np.zeros((n,), np.int32)
        code = np.zeros((n,), np.int8)
        for ab in self.blocks:
            if ab.offset >= self.tail_start:
                lo = ab.offset - self.tail_start
                gid[lo:lo + ab.words] = ab.gid
                code[lo:lo + ab.words] = dtype_code(
                    self.partition.leaves[ab.leaf].dtype)
        return gid, code

    # -- host-side routing (O(selected), not O(table)) -----------------------

    def blocks_for_gids(self, global_ids) -> np.ndarray:
        """Ascending arena-block indices covering the given gids (every
        colocated leaf's segment rides along: they share gids)."""
        gids = np.unique(np.asarray(global_ids, np.int64).ravel())
        if gids.size == 0:
            return np.empty((0,), np.int64)
        parts = [self.gid_ab[self.gid_ptr[g]:self.gid_ptr[g + 1]]
                 for g in gids]
        return np.sort(np.concatenate(parts))

    def tiles_for_blocks(self, global_ids) -> np.ndarray:
        """Ascending unique tile indices touched by the given gids (tail
        blocks may share tiles, hence the dedup)."""
        return self.ab_tiles(self.blocks_for_gids(global_ids))

    def ab_tiles(self, abs_: np.ndarray) -> np.ndarray:
        """Ascending unique int32 tiles touched by the given arena blocks."""
        if abs_.size == 0:
            return np.empty((0,), np.int32)
        t0, nt = self.ab_t0[abs_], self.ab_nt[abs_]
        starts = np.cumsum(nt) - nt
        tiles = np.repeat(t0, nt) + (np.arange(int(nt.sum()))
                                     - np.repeat(starts, nt))
        return np.unique(tiles).astype(np.int32)

    def split_tail_blocks(self, global_ids) -> tuple[np.ndarray, np.ndarray]:
        """Arena-block indices of the given gids, split into (main-region,
        tail-region): the two save granularities."""
        abs_ = self.blocks_for_gids(global_ids)
        if abs_.size == 0 or not self.has_tail:
            return abs_, np.empty((0,), np.int64)
        tail = self.ab_arrays()["offset"][abs_] >= self.tail_start
        return abs_[~tail], abs_[tail]

    def seg_bytes_for_blocks(self, global_ids) -> int:
        """Bytes a save of these gids moves: whole touched tiles for
        main-region blocks, payload words for tail blocks."""
        main, tail = self.split_tail_blocks(global_ids)
        tiles = self.ab_tiles(main).size
        words = int(self.ab_arrays()["payload"][tail].sum())
        return 4 * (ARENA_TILE * tiles + words)


def as_live_arena(x: Any, layout: Optional[ArenaLayout]):
    """Return ``x`` when it is a live flat arena for ``layout`` (a 1-D
    int32 tensor of ``total_words``), else None. The controller, the
    fabric and the sweep accept either form through this one predicate."""
    if layout is None:
        return None
    if isinstance(x, torch.Tensor) and x.dim() == 1 \
            and x.numel() == layout.total_words and x.dtype == torch.int32:
        return x
    return None


def build_arena_layout(partition: BlockPartition,
                       tail_pack: bool = True) -> ArenaLayout:
    """Lay out ``partition`` in the flat word arena: main-region leaves
    first in flatten order (tile-aligned segments), then tail leaves
    (single-block, payload under ``ARENA_TILE`` words) back to back at word
    granularity, then re-align to a tile. ``tail_pack=False`` keeps every
    segment tile-aligned."""
    br = partition.block_rows
    n = len(partition.leaves)
    pw_leaf = [leaf_word_width(leaf, br) for leaf in partition.leaves]
    is_tail = [tail_pack and leaf.n_blocks == 1 and pw_leaf[li] < ARENA_TILE
               for li, leaf in enumerate(partition.leaves)]
    order = ([li for li in range(n) if not is_tail[li]]
             + [li for li in range(n) if is_tail[li]])
    blocks: list[ArenaBlock] = []
    leaf_offset = [0] * n
    seg_words = [0] * n
    off = 0
    tail_start = None
    for li in order:
        leaf = partition.leaves[li]
        seg = pw_leaf[li] if is_tail[li] else _align(pw_leaf[li])
        if is_tail[li] and tail_start is None:
            tail_start = off
        leaf_offset[li] = off
        seg_words[li] = seg
        for b in range(leaf.n_blocks):
            blocks.append(ArenaBlock(leaf=li, gid=leaf.offset + b,
                                     offset=off, words=seg,
                                     payload=pw_leaf[li]))
            off += seg
    total_words = _align(off)
    if tail_start is None:
        tail_start = total_words
    ab_gid = np.asarray([ab.gid for ab in blocks], np.int64)
    gid_order = np.argsort(ab_gid, kind="stable")
    gid_ptr = np.searchsorted(ab_gid[gid_order],
                              np.arange(partition.total_blocks + 1))
    ab_t0 = np.asarray([ab.offset // ARENA_TILE for ab in blocks], np.int64)
    ab_last = np.asarray([(ab.offset + max(ab.words, 1) - 1) // ARENA_TILE
                          for ab in blocks], np.int64)
    return ArenaLayout(partition=partition, blocks=tuple(blocks),
                       leaf_offset=tuple(leaf_offset),
                       seg_words=tuple(seg_words),
                       payload_words=tuple(pw_leaf),
                       total_words=total_words,
                       ab_t0=ab_t0, ab_nt=ab_last - ab_t0 + 1,
                       gid_ab=gid_order, gid_ptr=gid_ptr,
                       tail_start=tail_start, leaf_order=tuple(order))


# ---------------------------------------------------------------------------
# pack / unpack / restore
# ---------------------------------------------------------------------------

def pack_arena(values: PyTree, layout: ArenaLayout) -> torch.Tensor:
    """Pack a tree into the flat ``(total_words,)`` int32 arena, on the
    leaves' device: one read of every leaf, one write of the arena (pad
    words are zeroed, the rest written once)."""
    part = layout.partition
    leaves = tree_leaves(values)
    out = torch.empty((layout.total_words,), dtype=torch.int32,
                      device=leaves[0].device)
    end = 0
    for li in layout.leaf_order:
        leaf = part.leaves[li]
        seg, pw = layout.seg_words[li], layout.payload_words[li]
        off = layout.leaf_offset[li]
        dst = out[off:off + leaf.n_blocks * seg].view(leaf.n_blocks, seg)
        dst[:, :pw].copy_(leaf_block_words(leaves[li], part.block_rows))
        if seg > pw:
            dst[:, pw:].zero_()
        end = off + leaf.n_blocks * seg
    out[end:].zero_()
    return out


def _decode_leaf(arena: torch.Tensor, layout: ArenaLayout,
                 li: int) -> torch.Tensor:
    """Leaf ``li`` decoded from its contiguous arena slice, in leaf shape
    (a view of the arena where the f32 payload fills its segments)."""
    leaf = layout.partition.leaves[li]
    seg = layout.seg_words[li]
    off = layout.leaf_offset[li]
    view = arena[off:off + leaf.n_blocks * seg].view(leaf.n_blocks, seg)
    return decode_block_words(view, leaf, layout.partition.block_rows)


def unpack_arena(arena: torch.Tensor, layout: ArenaLayout) -> PyTree:
    """Inverse of :func:`pack_arena`, bit-exact (I3). Every leaf owns its
    memory: later in-place saves into ``arena`` do not show through."""
    out = []
    for li in range(len(layout.partition.leaves)):
        x = _decode_leaf(arena, layout, li)
        if x.untyped_storage().data_ptr() == \
                arena.untyped_storage().data_ptr():
            x = x.clone()
        out.append(x)
    return tree_unflatten(layout.partition.treedef, out)


def arena_drift_scores(live: torch.Tensor, ref: torch.Tensor,
                       layout: ArenaLayout) -> torch.Tensor:
    """Per-gid squared drift ``||live_b - ref_b||^2`` -> (total_blocks,)
    f32, each word decoded by its stored dtype.

    The score half of the arena sweep (``kernels/fused_maintain``): on a
    CUDA arena it is the arena_maintain kernel with no parity output, on a
    CPU arena its plain version. Main-region tiles reduce per tile first,
    tail words per tail block, then each gid sums its parts in a fixed
    order."""
    from repro_torch.kernels.fused_maintain.ops import arena_sweep, score_plan
    return arena_sweep(live, ref, score_plan(layout))


def arena_restore(dst: PyTree, arena: torch.Tensor, global_mask,
                  layout: ArenaLayout) -> PyTree:
    """Overwrite the masked blocks of ``dst`` from the arena: each touched
    leaf decodes one contiguous arena slice and goes through the
    masked_restore kernel (its plain version on the CPU); untouched leaves
    pass through as the same tensors. Returns a new tree."""
    from repro_torch.kernels.masked_restore.ops import masked_restore
    part = layout.partition
    mask = np.asarray(global_mask, bool)
    out = []
    leaves = tree_leaves(dst)
    for li, (x, leaf) in enumerate(zip(leaves, part.leaves)):
        seg = mask[leaf.offset:leaf.offset + leaf.n_blocks]
        if not seg.any():
            out.append(x)
            continue
        shape2d = (max(leaf.rows, 1), max(leaf.row_width, 1))
        decoded = _decode_leaf(arena, layout, li).to(x.dtype)
        m = torch.from_numpy(seg.copy()).to(x.device)
        r = masked_restore(x.reshape(shape2d), decoded.reshape(shape2d), m,
                           part.block_rows)
        out.append(r.reshape(leaf.shape))
    return tree_unflatten(part.treedef, out)
