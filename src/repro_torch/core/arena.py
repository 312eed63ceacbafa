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

Invariants (the reference's I1-I4): main offsets and words are tile
multiples and tail blocks are word-contiguous; segments are disjoint and
cover ``[0, data_words)`` except the zero tail-alignment gap, and
``[data_words, total_words)`` is the **shard pad**, zero tiles appended so
that ``n_tiles`` divides ``shards`` (empty for ``shards=1``);
``unpack(pack(tree)) == tree`` bit for bit; pad words are zero after
``pack`` and every arena mutation keeps them zero.

Routing tables are **per tile** for the main region (``tile_gids``,
``tile_codes``) and per word only for the tail region (``tail_tables``):
a per-word table of a 1.5 B-value model would hold 1.5 B host entries.
Alongside the word domain the layout describes a **value domain**, the LM
trainer's optimizer seam: per leaf, ``seg_elems = seg_words * ratio`` f32
values per block at ``value_offset``. ``pack_values`` packs a tree of
gradients into it, and ``decode_values``/``encode_values`` move between
the two domains one coalesced same-dtype run at a time
(``value_runs``); for an all-f32 layout both are the identity.

**Sharded form.** On a mesh of ``n`` ranks the layout is built with
``shards=n``: rank ``r`` owns the contiguous word span ``[r * total / n,
(r + 1) * total / n)`` (:meth:`ArenaLayout.span`), a whole number of tiles,
and holds only that span of every arena-shaped buffer. The data region is
the same for every shard count, so :func:`relayout_arena` and
:func:`relayout_values` move a buffer across a shard-count change by a
slice and a re-pad, bit for bit; :func:`arena_block_homes` derives each
block's home from span ownership.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.blocks import (WORD_DTYPE_NAMES, BlockPartition,
                                     decode_block_words, dtype_word_ratio,
                                     leaf_block_view, leaf_block_words,
                                     leaf_frame_width, leaf_word_width,
                                     word_packable)
from repro_torch.kernels.leaf_table import leaf_arrays
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
    total_words: int                    # ARENA_TILE multiple (shard pad incl.)
    ab_t0: np.ndarray                   # (n_ab,) first tile per arena block
    ab_nt: np.ndarray                   # (n_ab,) touched tiles per arena block
    gid_ab: np.ndarray                  # arena blocks sorted by gid (CSR)
    gid_ptr: np.ndarray                 # (total_blocks + 1,) CSR pointers
    tail_start: int                     # word offset of the tail region
    leaf_order: tuple[int, ...]         # leaf indices in offset order
    payload_elems: tuple[int, ...]      # live elements per block, per leaf
    seg_elems: tuple[int, ...]          # value-domain elems per block, per leaf
    value_offset: tuple[int, ...]       # value-domain start per leaf
    total_values: int                   # f32 value-domain length
    shards: int = 1                     # even flat-sharding divisor of n_tiles
    data_words: int = -1                # words before the shard pad

    @property
    def n_tiles(self) -> int:
        return self.total_words // ARENA_TILE

    @property
    def pad_words(self) -> int:
        """Zero words of the shard pad (0 when ``shards == 1``)."""
        return self.total_words - (self.total_words if self.data_words < 0
                                   else self.data_words)

    @property
    def shard_words(self) -> int:
        """Words each of the ``shards`` flat shards owns (a tile multiple)."""
        return self.total_words // self.shards

    def span(self, position: int) -> tuple[int, int]:
        """The word span ``[w0, w1)`` of shard ``position``."""
        if not 0 <= position < self.shards:
            raise ValueError(f"shard {position} of {self.shards}")
        sw = self.shard_words
        return position * sw, (position + 1) * sw

    def span_runs(self, position: int) -> tuple:
        """:meth:`value_runs` of shard ``position``'s span, relative to the
        span (one f32 run: a sharded layout is all-f32)."""
        if not self.uniform_f32:
            raise ValueError("a sharded arena holds an all-f32 model")
        sw = self.shard_words
        return ((0, sw, 0, sw, torch.float32),)

    @property
    def nbytes(self) -> int:
        return self.total_words * 4

    @property
    def has_tail(self) -> bool:
        return 0 <= self.tail_start < self.data_words

    @property
    def uniform_f32(self) -> bool:
        """True when every leaf is f32: words are values and the value
        domain is the identity (``total_values == total_words``)."""
        return all(l.dtype == torch.float32 for l in self.partition.leaves)

    def value_runs(self) -> tuple[tuple[int, int, int, int, torch.dtype],
                                  ...]:
        """Cached coalesced decode/encode plan: ``(word_start, words,
        value_start, values, dtype)`` per run of consecutive same-dtype
        leaves in offset order (pads ride inside their leaf's run; the
        tail-alignment gap closes an f32 run). An all-f32 or an all-bf16
        model is one run."""
        cached = getattr(self, "_value_runs", None)
        if cached is None:
            runs: list[list] = []   # [w0, nw, v0, nv, dtype]
            w = v = 0

            def push(nw: int, nv: int, dt: torch.dtype) -> None:
                nonlocal w, v
                if nw == 0:
                    return
                if runs and runs[-1][4] == dt:
                    runs[-1][1] += nw
                    runs[-1][3] += nv
                else:
                    runs.append([w, nw, v, nv, dt])
                w += nw
                v += nv

            for li in self.leaf_order:
                leaf = self.partition.leaves[li]
                dt = leaf.dtype if word_packable(leaf.dtype) \
                    else torch.float32
                push(self.seg_words[li] * leaf.n_blocks,
                     self.seg_elems[li] * leaf.n_blocks, dt)
            push(self.total_words - w, self.total_values - v, torch.float32)
            assert w == self.total_words and v == self.total_values
            cached = tuple(tuple(r) for r in runs)
            object.__setattr__(self, "_value_runs", cached)
        return cached

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
        reductions use :meth:`tail_tables` there. Shard-pad tiles report
        gid 0: their words are zero in every arena, so a per-gid reduction
        over them adds an exact +0.0."""
        gids = np.zeros((self.n_tiles,), np.int32)
        tiles, abi = self.main_tiles()
        gids[tiles] = self.ab_arrays()["gid"][abi]
        if self.has_tail:
            gids[self.tail_start // ARENA_TILE:
                 self.data_words // ARENA_TILE] = -1
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


def build_arena_layout(partition: BlockPartition, shards: int = 1,
                       tail_pack: bool = True) -> ArenaLayout:
    """Lay out ``partition`` in the flat word arena: main-region leaves
    first in flatten order (tile-aligned segments), then tail leaves
    (single-block, payload under ``ARENA_TILE`` words) back to back at word
    granularity, then re-align to a tile. ``tail_pack=False`` keeps every
    segment tile-aligned. ``shards > 1`` appends zero tiles so that
    ``n_tiles % shards == 0``: every flat shard then owns whole tiles, and
    the data region ``[0, data_words)`` is the ``shards=1`` layout's."""
    if shards < 1:
        raise ValueError(f"shards must be >= 1, got {shards}")
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
    payload_elems = [0] * n
    seg_elems = [0] * n
    value_offset = [0] * n
    off = voff = 0
    tail_start = None
    for li in order:
        leaf = partition.leaves[li]
        seg = pw_leaf[li] if is_tail[li] else _align(pw_leaf[li])
        if is_tail[li] and tail_start is None:
            tail_start = off
        r = dtype_word_ratio(leaf.dtype)
        leaf_offset[li] = off
        seg_words[li] = seg
        payload_elems[li] = leaf_frame_width(leaf, br)
        seg_elems[li] = seg * r
        value_offset[li] = voff
        for b in range(leaf.n_blocks):
            blocks.append(ArenaBlock(leaf=li, gid=leaf.offset + b,
                                     offset=off, words=seg,
                                     payload=pw_leaf[li]))
            off += seg
            voff += seg * r
    data_words = _align(off)
    pad_tiles = (-(data_words // ARENA_TILE)) % shards
    total_words = data_words + pad_tiles * ARENA_TILE
    # the alignment gap and the shard pad hold f32 values
    total_values = voff + total_words - off
    if tail_start is None:
        tail_start = data_words
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
                       tail_start=tail_start, leaf_order=tuple(order),
                       payload_elems=tuple(payload_elems),
                       seg_elems=tuple(seg_elems),
                       value_offset=tuple(value_offset),
                       total_values=total_values, shards=shards,
                       data_words=data_words)


def span_overlaps(old_n: int, old_size: int, new_n: int, new_size: int,
                  data: int) -> list[tuple[int, int, int, int]]:
    """How a flat-sharded buffer moves across a shard-count change: ``(p,
    q, lo, hi)`` for each old shard ``p`` (``old_size`` elements each) and
    new shard ``q`` (``new_size`` each) whose spans share the elements
    ``[lo, hi)`` before ``data`` (the shard pad, zero in every layout, is
    never moved), ascending in ``p`` then ``q``. The one arithmetic of
    :func:`relayout_arena`, :func:`relayout_values` and the mesh's
    :func:`~repro_torch.distributed.collectives.respan`."""
    out = []
    for p in range(old_n):
        a0, a1 = p * old_size, min((p + 1) * old_size, data)
        for q in range(new_n):
            lo = max(a0, q * new_size)
            hi = min(a1, (q + 1) * new_size)
            if hi > lo:
                out.append((p, q, lo, hi))
    return out


def _relayout(buf: torch.Tensor, old_size: int, new_size: int,
              data: int) -> torch.Tensor:
    """``buf`` as one shard of ``new_size`` elements: the moves of
    :func:`span_overlaps` between one old and one new shard."""
    out = buf.new_zeros((new_size,))
    for _, _, lo, hi in span_overlaps(1, old_size, 1, new_size, data):
        out[lo:hi] = buf[lo:hi]
    return out


def relayout_arena(arena: torch.Tensor, old: ArenaLayout,
                   new: ArenaLayout) -> torch.Tensor:
    """An arena of ``old`` as an arena of ``new`` (the same partition at
    another shard count), bit for bit: the data region is kept and the
    shard pad re-sized with zeros. On the buffer's device."""
    if old.data_words != new.data_words:
        raise ValueError("relayout_arena: layouts disagree on the data "
                         f"region ({old.data_words} vs {new.data_words} "
                         "words): not the same partition")
    if arena.numel() != old.total_words:
        raise ValueError(f"need a ({old.total_words},) arena, got "
                         f"{tuple(arena.shape)}")
    return _relayout(arena, old.total_words, new.total_words, new.data_words)


def relayout_values(buf: torch.Tensor, old: ArenaLayout,
                    new: ArenaLayout) -> torch.Tensor:
    """The value-domain counterpart of :func:`relayout_arena` (optimizer
    moments across a shard-count change): the region before the shard pad
    is kept, the pad re-sized with zeros."""
    d_old = old.total_values - old.pad_words
    d_new = new.total_values - new.pad_words
    if d_old != d_new:
        raise ValueError("relayout_values: layouts disagree on the data "
                         f"region ({d_old} vs {d_new} values): not the same "
                         "partition")
    return _relayout(buf, old.total_values, new.total_values, d_new)


def arena_block_homes(layout: ArenaLayout,
                      n_devices: Optional[int] = None) -> np.ndarray:
    """(total_blocks,) home shard of each gid, from flat-shard span
    ownership: the shard whose word span holds the first tile of the gid's
    first arena block. With ``shards == n_devices`` a shard's home blocks
    are the tile-aligned segments it already owns, so the sweep and the
    partial save read local tiles (and the tiles of blocks that straddle a
    span boundary)."""
    n = layout.shards if n_devices is None else int(n_devices)
    if layout.n_tiles % n:
        raise ValueError(f"n_tiles {layout.n_tiles} not divisible by "
                         f"{n} devices: build the layout with shards={n}")
    tiles_per = layout.n_tiles // n
    first_ab = layout.gid_ab[layout.gid_ptr[:-1]]
    return (layout.ab_t0[first_ab] // tiles_per).astype(np.int64)


# ---------------------------------------------------------------------------
# pack / unpack / restore
# ---------------------------------------------------------------------------

def pack_arena(values: PyTree, layout: ArenaLayout,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pack a tree into the flat ``(total_words,)`` int32 arena, on the
    leaves' device: one read of every leaf, one write of the arena (pad
    words are zeroed, the rest written once). With ``out``, into that
    arena in place; a leaf that is a view of its own slot there
    (:func:`unpack_arena` with ``copy=False``) is already in place."""
    part = layout.partition
    leaves = tree_leaves(values)
    if out is None:
        out = torch.empty((layout.total_words,), dtype=torch.int32,
                          device=leaves[0].device)
    end = 0
    for li in layout.leaf_order:
        leaf = part.leaves[li]
        seg, pw = layout.seg_words[li], layout.payload_words[li]
        off = layout.leaf_offset[li]
        dst = out[off:off + leaf.n_blocks * seg].view(leaf.n_blocks, seg)
        src = leaf_block_words(leaves[li], part.block_rows)
        if src.data_ptr() != dst.data_ptr():
            dst[:, :pw].copy_(src)
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


def unpack_arena(arena: torch.Tensor, layout: ArenaLayout,
                 copy: bool = True) -> PyTree:
    """Inverse of :func:`pack_arena`, bit-exact (I3). With ``copy`` every
    leaf owns its memory: later in-place saves into ``arena`` do not show
    through. Without it, a leaf whose payload fills its segments is a view
    of the arena (the train step's read-only operands: no second copy of
    the model), and only the others are decoded copies."""
    out = []
    for li in range(len(layout.partition.leaves)):
        x = _decode_leaf(arena, layout, li)
        if copy and x.untyped_storage().data_ptr() == \
                arena.untyped_storage().data_ptr():
            x = x.clone()
        out.append(x)
    return tree_unflatten(layout.partition.treedef, out)


# ---------------------------------------------------------------------------
# value domain (the optimizer seam)
# ---------------------------------------------------------------------------

def pack_values(values: PyTree, layout: ArenaLayout) -> torch.Tensor:
    """Pack a tree into the flat ``(total_values,)`` f32 value buffer, the
    gradient and moment counterpart of :func:`pack_arena`: each leaf's
    block view cast to f32 at ``value_offset``, every pad 0.0. For an
    all-f32 layout it holds the same bits as ``pack_arena``."""
    part = layout.partition
    leaves = tree_leaves(values)
    out = torch.empty((layout.total_values,), dtype=torch.float32,
                      device=leaves[0].device)
    end = 0
    for li in layout.leaf_order:
        leaf = part.leaves[li]
        se, pe = layout.seg_elems[li], layout.payload_elems[li]
        off = layout.value_offset[li]
        dst = out[off:off + leaf.n_blocks * se].view(leaf.n_blocks, se)
        dst[:, :pe].copy_(leaf_block_view(leaves[li], part.block_rows))
        if se > pe:
            dst[:, pe:].zero_()
        end = off + leaf.n_blocks * se
    out[end:].zero_()
    return out


def accumulate_values(acc: torch.Tensor, leaves: list,
                      layout: ArenaLayout) -> torch.Tensor:
    """``acc += pack_values(leaves)`` in place, leaf by leaf, with no
    packed image: each leaf's block view is added in f32 into its slice of
    the ``(total_values,)`` accumulator and rounded to ``acc``'s dtype
    (the tree path's ``(a.f32 + g.f32).to(a.dtype)``, value for value);
    pads are left as they are. ``leaves`` is a list in leaf order; each
    entry is set to None once added, so a caller holding no other
    reference frees it there."""
    part = layout.partition
    for li in layout.leaf_order:
        leaf = part.leaves[li]
        se, pe = layout.seg_elems[li], layout.payload_elems[li]
        off = layout.value_offset[li]
        dst = acc[off:off + leaf.n_blocks * se].view(leaf.n_blocks, se)
        src = leaf_block_view(leaves[li], part.block_rows)
        leaves[li] = None
        if acc.dtype == torch.float32:
            dst[:, :pe].add_(src)
        else:
            dst[:, :pe].copy_(dst[:, :pe].to(torch.float32)
                              + src.to(torch.float32))
        del src
    return acc


def decode_words(words: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A run's int32 words -> its f32 values (``dtype_word_ratio`` values
    a word, element 0 in the low-order bytes)."""
    if dtype == torch.float32:
        return words.view(torch.float32)
    return words.view(dtype).to(torch.float32)


def encode_words(values: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of :func:`decode_words`: f32 values -> int32 words, the
    values cast to ``dtype`` (round to nearest even, as ``astype``) and
    bitcast."""
    if dtype == torch.float32:
        return values.view(torch.int32)
    return values.to(dtype).view(torch.int32)


def decode_values(arena: torch.Tensor, layout: ArenaLayout) -> torch.Tensor:
    """Word arena -> ``(total_values,)`` f32 values, one slice and bitcast
    per coalesced same-dtype run (a float view of the arena itself for an
    all-f32 layout). Sub-word pads decode to 0.0."""
    if layout.uniform_f32:
        return arena.view(torch.float32)
    parts = [decode_words(arena[w0:w0 + nw], dt)
             for w0, nw, _v0, _nv, dt in layout.value_runs()]
    return torch.cat(parts) if len(parts) > 1 else parts[0]


def encode_values(values: torch.Tensor, layout: ArenaLayout
                  ) -> torch.Tensor:
    """Inverse of :func:`decode_values`: re-encode the f32 value buffer
    into ``(total_words,)`` int32 arena words (0.0 pads re-encode to zero
    bits, invariant I4)."""
    if layout.uniform_f32:
        return values.view(torch.int32)
    parts = [encode_words(values[v0:v0 + nv], dt)
             for _w0, _nw, v0, nv, dt in layout.value_runs()]
    return torch.cat(parts) if len(parts) > 1 else parts[0]


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
    """Overwrite the masked blocks of ``dst`` from the arena; untouched
    leaves pass through as the same tensors. Returns a new tree.

    On CUDA one grouped masked_restore launch restores every touched leaf
    (:func:`arena_sources` says where each reads); on the CPU its plain
    version runs leaf by leaf (:func:`arena_restore_ref`)."""
    if arena.device.type == "cpu":
        return arena_restore_ref(dst, arena, global_mask, layout)
    from repro_torch.kernels.masked_restore.kernel import \
        masked_restore_tree_cuda
    part = layout.partition
    mask = np.array(global_mask, bool)
    leaves = tree_leaves(dst)
    touched = touched_leaves(mask, part)
    # the mask goes up from page-locked memory without waiting: a pageable
    # copy would hold the host until the card had drained its stream
    dev_mask = torch.from_numpy(mask).pin_memory().to(arena.device,
                                                      non_blocking=True)
    out = masked_restore_tree_cuda(
        leaves, arena_sources(leaves, arena, touched, layout), dev_mask,
        part, touched)
    return tree_unflatten(part.treedef, [x if r is None else r
                                         for x, r in zip(leaves, out)])


def touched_leaves(mask: np.ndarray, partition: BlockPartition) -> np.ndarray:
    """Indices of the leaves that hold a block of the (total_blocks,) bool
    ``mask``, from one cumulative sum."""
    if mask.shape != (partition.total_blocks,):
        raise ValueError(f"need a ({partition.total_blocks},) mask, got "
                         f"{mask.shape}")
    g = leaf_arrays(partition)
    seen = np.concatenate([[0], np.cumsum(mask, dtype=np.int64)])
    return np.flatnonzero(seen[g.offset + g.n_blocks] > seen[g.offset])


def arena_sources(leaves: list, arena: torch.Tensor, touched: np.ndarray,
                  layout: ArenaLayout) -> list:
    """Where the grouped restore reads each touched leaf (None for the
    rest): its segments in the arena, read in place as an ``(address,
    pitch)`` pair, where dst has the leaf's own dtype (a word-packable
    leaf's segment holds its values' bytes in order from the segment's
    start, so the segments' pitch is its block pitch); else the decoded
    leaf, converted to dst's dtype."""
    if arena.dtype != torch.int32 or not arena.is_contiguous() \
            or arena.numel() != layout.total_words:
        raise ValueError(f"need a contiguous ({layout.total_words},) int32 "
                         f"arena, got {tuple(arena.shape)} {arena.dtype}")
    if touched.size and leaves[touched[0]].device != arena.device:
        raise ValueError(f"leaves on {leaves[touched[0]].device}, the arena "
                         f"on {arena.device}")
    part = layout.partition
    base = arena.data_ptr()
    srcs = [None] * len(leaves)
    for li in touched.tolist():
        leaf, x = part.leaves[li], leaves[li]
        if x.dtype == leaf.dtype and word_packable(leaf.dtype):
            srcs[li] = (base + 4 * layout.leaf_offset[li],
                        4 * layout.seg_words[li])
        else:
            srcs[li] = _decode_leaf(arena, layout, li).to(x.dtype)
    return srcs


def arena_restore_ref(dst: PyTree, arena: torch.Tensor, global_mask,
                      layout: ArenaLayout) -> PyTree:
    """:func:`arena_restore`'s plain version: each touched leaf decoded from
    its contiguous arena slice and selected with ``masked_restore_ref``."""
    from repro_torch.kernels.masked_restore.ref import masked_restore_ref
    part = layout.partition
    mask = np.asarray(global_mask, bool)
    out = []
    for li, (x, leaf) in enumerate(zip(tree_leaves(dst), part.leaves)):
        seg = mask[leaf.offset:leaf.offset + leaf.n_blocks]
        if not seg.any():
            out.append(x)
            continue
        shape2d = (max(leaf.rows, 1), max(leaf.row_width, 1))
        decoded = _decode_leaf(arena, layout, li).to(x.dtype)
        m = torch.from_numpy(seg.copy()).to(x.device)
        r = masked_restore_ref(x.reshape(shape2d), decoded.reshape(shape2d),
                               m, part.block_rows)
        out.append(r.reshape(leaf.shape))
    return tree_unflatten(part.treedef, out)
