"""XOR parity over the flat arena: encode and single-erasure reconstruct.

The reference folds ``out[j] = base[j] ^ XOR_{i: keep[j, i]} frames[j, i]``
over ``(n_groups, g, frame_elems)`` member frames gathered from a
``(total_blocks, frame_elems)`` frames buffer. Here a member's frame is
never built: it is the side-by-side of the member's arena segments at their
frame columns (``FrameLayout.cols``), so each kept member contributes one
**term** per arena segment, ``(destination column, arena word offset,
length)``, and the kernel reads those words in place. A :class:`ParityPlan`
holds the rows and terms:

- :func:`encode_plan`: one row per group, its whole parity frame, base 0,
  a term per member segment; the output is the ``(n_groups, frame_elems)``
  parity.
- :func:`reconstruct_plan`: one row per arena segment of each block to
  recover, base its group's parity at the segment's columns, a term per
  overlap of a surviving member's segment with those columns; the output
  is the lost segments' arena words, which decode straight into the tree.

:func:`parity_xor` runs the kernel on CUDA tensors and the plain version on
CPU tensors.

The kernel does not walk the terms per word. :func:`build_pieces` splits
every row at its terms' start and end columns into **pieces**, maximal runs
of words that the same terms cover, and lists each piece's terms with
their source offsets at its first word; a CTA takes a tile of
``TILE_WORDS`` words of one piece. gf256_mac's :class:`GFPlan
<repro_torch.kernels.gf256_mac.ops.GFPlan>` runs on the same pieces.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels.parity_xor.kernel import (TILE_WORDS,
                                                   parity_xor_cuda)
from repro_torch.kernels.parity_xor.ref import parity_xor_ref


@dataclasses.dataclass(eq=False)
class Pieces:
    """A plan's rows split into pieces (numpy). Piece ``p`` writes
    ``length[p]`` words at ``out[p]`` (its row's offset plus its first
    column), seeded from ``base[p]`` (-1: zeros), and folds the entries
    ``term_ptr[p] .. term_ptr[p + 1]``: entry ``e`` is the plan's term
    ``term[e]``, read from ``term_src[e]`` at the piece's first word. Row
    ``r``'s pieces are ``row_piece[r] .. row_piece[r + 1]``; piece ``p``'s
    tiles are ``piece_tile[p] .. piece_tile[p + 1]``, tile ``t`` the words
    ``[tile_lo[t], tile_lo[t] + tile_words)`` of piece ``tile_piece[t]``
    (cut at its end)."""
    row_piece: np.ndarray   # int64 (n_rows + 1,)
    out: np.ndarray         # int64
    length: np.ndarray      # int32
    base: np.ndarray        # int64
    term_ptr: np.ndarray    # int64 (n_pieces + 1,)
    term: np.ndarray        # int64
    term_src: np.ndarray    # int64
    piece_tile: np.ndarray  # int64 (n_pieces + 1,)
    tile_piece: np.ndarray  # int32
    tile_lo: np.ndarray     # int32
    tile_words: int

    def tiles(self, row0: int, n_rows: int) -> tuple[int, int]:
        """The tiles ``[t0, t1)`` of rows ``[row0, row0 + n_rows)``."""
        p0, p1 = self.row_piece[row0], self.row_piece[row0 + n_rows]
        return int(self.piece_tile[p0]), int(self.piece_tile[p1])


def _ptr(counts: np.ndarray) -> np.ndarray:
    return np.concatenate([[0], np.cumsum(counts, dtype=np.int64)])


def build_pieces(plan, tile_words=None) -> Pieces:
    """Split every row of ``plan`` (a :class:`ParityPlan` or a
    :class:`~repro_torch.kernels.gf256_mac.ops.GFPlan`) at its terms'
    start and end columns (vectorised per term and row, never per word),
    and the pieces into tiles of ``tile_words`` words (default
    ``TILE_WORDS``). Words no term covers become zero-term pieces (a base
    copy or a zero fill). Raises if a term leaves its row."""
    tile_words = TILE_WORDS if tile_words is None else int(tile_words)
    row_len = np.asarray(plan.row_len, np.int64)
    n_rows = row_len.size
    t_row = np.repeat(np.arange(n_rows, dtype=np.int64),
                      np.diff(np.asarray(plan.term_ptr, np.int64)))
    d0 = np.asarray(plan.term_dst, np.int64)
    d1 = d0 + np.asarray(plan.term_len, np.int64)
    if ((d0 < 0) | (d1 > row_len[t_row]) | (d1 < d0)).any():
        raise ValueError("a term reaches outside its row")
    span = int(max(row_len.max(initial=0), d1.max(initial=0))) + 1
    rows = np.arange(n_rows, dtype=np.int64)
    key = np.unique(np.concatenate([rows * span, rows * span + row_len,
                                    t_row * span + d0, t_row * span + d1]))
    same = key[1:] // span == key[:-1] // span
    p_key = key[:-1][same]
    p_row, p_start = p_key // span, p_key % span
    p_len = key[1:][same] - p_key
    # term k covers the pieces [ka, kb) of its row, whole
    ka = np.searchsorted(p_key, t_row * span + d0)
    kb = np.searchsorted(p_key, t_row * span + d1)
    n_cov = kb - ka
    first = np.repeat(ka - _ptr(n_cov)[:-1], n_cov)
    e_piece = first + np.arange(int(n_cov.sum()), dtype=np.int64)
    e_term = np.repeat(np.arange(n_cov.size, dtype=np.int64), n_cov)
    order = np.argsort(e_piece, kind="stable")
    e_piece, e_term = e_piece[order], e_term[order]
    base = np.asarray(plan.row_base, np.int64)[p_row]
    n_tiles = -(-p_len // tile_words)
    piece_tile = _ptr(n_tiles)
    tile_piece = np.repeat(np.arange(p_len.size, dtype=np.int64), n_tiles)
    tile_lo = (np.arange(int(piece_tile[-1]), dtype=np.int64)
               - piece_tile[tile_piece]) * tile_words
    return Pieces(
        row_piece=np.searchsorted(p_row, np.arange(n_rows + 1)).astype(
            np.int64),
        out=np.asarray(plan.row_out, np.int64)[p_row] + p_start,
        length=p_len.astype(np.int32),
        base=np.where(base >= 0, base + p_start, -1),
        term_ptr=_ptr(np.bincount(e_piece, minlength=p_len.size)),
        term=e_term,
        term_src=np.asarray(plan.term_src, np.int64)[e_term]
        + p_start[e_piece] - d0[e_term],
        piece_tile=piece_tile, tile_piece=tile_piece.astype(np.int32),
        tile_lo=tile_lo.astype(np.int32), tile_words=int(tile_words))


class PiecedPlan:
    """What :class:`ParityPlan` and :class:`~repro_torch.kernels.gf256_mac.
    ops.GFPlan` share: their pieces, built once, and the pieces' tables on
    a device, uploaded once per device. Only the kernel reads these; the
    plain version reads the plan's own tables (``on``)."""

    def __post_init__(self):
        self._pieces = None
        self._pieces_on: dict[str, dict] = {}

    def pieces(self) -> Pieces:
        """The rows split into pieces (built once)."""
        if self._pieces is None:
            self._pieces = build_pieces(self)
        return self._pieces

    def pieces_on(self, device) -> dict:
        """The pieces' tables as tensors on ``device``, ``pc_out`` ..
        ``pc_tile_lo``, plus what the plan adds (``_piece_extras``)."""
        key = str(device)
        if key not in self._pieces_on:
            pc = self.pieces()
            t = {f"pc_{k}": torch.from_numpy(np.ascontiguousarray(
                     getattr(pc, k))).to(device)
                 for k in ("out", "length", "base", "term_ptr", "term_src",
                           "tile_piece", "tile_lo")}
            t.update(self._piece_extras(pc, device))
            self._pieces_on[key] = t
        return self._pieces_on[key]

    def _piece_extras(self, pc: Pieces, device) -> dict:
        raise NotImplementedError


@dataclasses.dataclass(eq=False)
class ParityPlan(PiecedPlan):
    """Rows and terms of one parity_xor launch (numpy). Row ``r`` writes
    ``row_len[r]`` words at ``row_out[r]``, seeded from ``base[row_base[r]:]``
    (zeros where -1), with terms ``term_ptr[r] .. term_ptr[r + 1]``: term
    ``k`` XORs ``src[term_src[k]:term_src[k] + term_len[k]]`` into the row's
    words ``[term_dst[k], term_dst[k] + term_len[k])``."""
    row_out: np.ndarray    # int64
    row_len: np.ndarray    # int32
    row_base: np.ndarray   # int64
    term_ptr: np.ndarray   # int64
    term_dst: np.ndarray   # int32
    term_src: np.ndarray   # int64
    term_len: np.ndarray   # int32

    @property
    def out_words(self) -> int:
        return int((self.row_out + self.row_len).max()) \
            if self.row_len.size else 0

    @property
    def src_words(self) -> int:
        return int((self.term_src + self.term_len).max()) \
            if self.term_len.size else 0

    @property
    def base_words(self) -> int:
        has = self.row_base >= 0
        return int((self.row_base + self.row_len)[has].max()) \
            if has.any() else 0

    @property
    def read_bytes(self) -> int:
        """Bytes the launch must read: every term's source words and every
        based row's base words."""
        return 4 * (int(self.term_len.sum())
                    + int(self.row_len[self.row_base >= 0].sum()))

    def on(self, device: torch.device) -> dict:
        """The tables as tensors on ``device``, plus the ints ``max_len``,
        ``out_words``, ``src_words`` and ``base_words``."""
        t = {f.name: torch.from_numpy(np.ascontiguousarray(
                 getattr(self, f.name))).to(device)
             for f in dataclasses.fields(self)}
        t.update(max_len=int(self.row_len.max()) if self.row_len.size else 0,
                 out_words=self.out_words, src_words=self.src_words,
                 base_words=self.base_words)
        return t

    def _piece_extras(self, pc: Pieces, device) -> dict:
        return dict(n_tiles=int(pc.piece_tile[-1]),
                    tile_words=pc.tile_words, out_words=self.out_words,
                    src_words=self.src_words, base_words=self.base_words)


def _plan(rows: list, terms: list) -> ParityPlan:
    """rows: (out, len, base) per row; terms: per row, a list of
    (dst, src, len)."""
    counts = np.asarray([len(ts) for ts in terms], np.int64)
    flat = [t for ts in terms for t in ts]
    tt = np.asarray(flat, np.int64).reshape(-1, 3)
    rr = np.asarray(rows, np.int64).reshape(-1, 3)
    return ParityPlan(row_out=rr[:, 0], row_len=rr[:, 1].astype(np.int32),
                      row_base=rr[:, 2],
                      term_ptr=np.concatenate([[0], np.cumsum(counts)]),
                      term_dst=tt[:, 0].astype(np.int32), term_src=tt[:, 1],
                      term_len=tt[:, 2].astype(np.int32))


def _segments(arena_layout, frame_layout, gids) -> list:
    """Per gid: its arena segments as (frame column, arena offset,
    payload words)."""
    out = []
    for g in gids:
        abs_ = arena_layout.gid_ab[arena_layout.gid_ptr[g]:
                                   arena_layout.gid_ptr[g + 1]]
        out.append([(frame_layout.cols[arena_layout.blocks[a].leaf],
                     arena_layout.blocks[a].offset,
                     arena_layout.blocks[a].payload) for a in abs_])
    return out


def encode_plan(arena_layout, frame_layout, members: np.ndarray) -> ParityPlan:
    """Group ``j``'s parity frame (row ``j`` of the ``(n_groups,
    frame_elems)`` output) = XOR of its valid members' frames."""
    fe = frame_layout.frame_elems
    segs = _segments(arena_layout, frame_layout,
                     range(arena_layout.partition.total_blocks))
    rows, terms = [], []
    for j, row in enumerate(np.asarray(members)):
        rows.append((j * fe, fe, -1))
        terms.append([s for b in row[row >= 0] for s in segs[int(b)]])
    return _plan(rows, terms)


def reconstruct_plan(arena_layout, frame_layout, group_of: np.ndarray,
                     members: np.ndarray, recover: np.ndarray,
                     keep: np.ndarray):
    """The plan that rebuilds the arena segments of the gids ``recover``
    (each the single erasure of its group): segment ``s`` of gid ``b`` in
    group ``j`` = parity ``j`` at the segment's columns, XOR the words the
    kept members (``keep``: (n_groups, width) bool over ``members``) hold
    at those columns. Returns ``(plan, blocks)``: the plan's output is the
    payload words of the arena blocks ``blocks``, back to back."""
    fe = frame_layout.frame_elems
    rows, terms, blocks = [], [], []
    out = 0
    for b in np.asarray(recover, np.int64):
        j = int(group_of[b])
        row = members[j]
        kept = _segments(arena_layout, frame_layout,
                         [int(m) for m in row[keep[j]] if m >= 0])
        abs_ = arena_layout.gid_ab[arena_layout.gid_ptr[b]:
                                   arena_layout.gid_ptr[b + 1]]
        for a in abs_:
            ab = arena_layout.blocks[a]
            col = frame_layout.cols[ab.leaf]
            rows.append((out, ab.payload, j * fe + col))
            ts = []
            for segs in kept:
                for c, off, n in segs:
                    lo, hi = max(col, c), min(col + ab.payload, c + n)
                    if lo < hi:
                        ts.append((lo - col, off + lo - c, hi - lo))
            terms.append(ts)
            blocks.append(int(a))
            out += ab.payload
    return _plan(rows, terms), np.asarray(blocks, np.int64)


def parity_xor(out: torch.Tensor, src: torch.Tensor, base,
               plan: ParityPlan) -> torch.Tensor:
    """Run ``plan``: the plain version for CPU tensors, the kernel
    otherwise. Returns ``out``."""
    if out.device.type == "cpu":
        return parity_xor_ref(out, src, base, plan.on(out.device))
    return parity_xor_cuda(out, src, base, plan.pieces_on(out.device))
