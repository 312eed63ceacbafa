"""The recovery of one rank's span of the sharded arena.

On a mesh the rank at position ``p`` holds the span ``layout.span(p)`` of
the live arena and of the running-checkpoint arena, the replica of the span
of position ``p - shift`` and the parity rows it owns
(:class:`~repro_torch.kernels.fused_maintain.ops.SpanMaintainProgram`). A
recovery restores each block where it lives, every rank on its own span
under the same plan; no rank holds more than a few spans:

- **the replica tier**: the span's replica, shipped back from the rank that
  holds it, restored into the span by masked_restore (:func:`span_restore`:
  the span's main-region tiles as ``(tiles, 1024)`` rows, one mask entry a
  tile, since a tile belongs to one block; its tail-region words as
  ``(words, 1)`` rows, since tail blocks share tiles);
- **the parity tier** (:func:`span_reconstruct`): each rank folds the terms
  of the reconstruct plan that read its span, seeded with the parity rows
  it owns, into a partial of the lost words (parity_xor); an all-to-all
  sends each partial word to the rank whose span the word restores, which
  folds the ``n`` partials (parity_xor) and writes them;
- **the running-checkpoint and disk tiers**: masked_restore from the span
  of the checkpoint arena;
- **the norms** (:func:`mesh_block_sq`): block_dist over the span's tiles
  and tail words, summed per block on the host, the ranks' partials
  all-gathered and added in position order, so every rank holds the same
  per-block sums (a block that straddles a span edge has a part on each
  side).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.arena import ARENA_TILE, ArenaLayout


@dataclasses.dataclass(frozen=True)
class SpanTables:
    """Where the blocks lie in one span, relative to the span: its first
    ``tile_gid.size`` tiles are main-region tiles (``tile_gid``: each one's
    gid); the words ``[tail_lo, tail_lo + tail_gid.size)`` are tail-region
    words (``tail_gid``: each one's gid, 0 in the alignment gap); the rest
    is shard pad."""
    position: int
    w0: int
    w1: int
    tile_gid: np.ndarray
    tail_lo: int
    tail_gid: np.ndarray


def span_tables(layout: ArenaLayout, position: int) -> SpanTables:
    """The :class:`SpanTables` of shard ``position`` (built once per layout
    and position)."""
    cache = getattr(layout, "_span_tables", None)
    if cache is None:
        cache = {}
        object.__setattr__(layout, "_span_tables", cache)
    if position not in cache:
        T = ARENA_TILE
        w0, w1 = layout.span(position)
        ts = (layout.tail_start if layout.has_tail
              else layout.data_words) // T
        t0, t1 = w0 // T, w1 // T
        tile_gid = layout.tile_gids()[t0:max(min(t1, ts), t0)]
        lo, hi = w0, w0
        tail_gid = np.empty((0,), np.int32)
        if layout.has_tail:
            lo = max(w0, layout.tail_start)
            hi = min(w1, layout.data_words)
            if hi > lo:
                tail_gid = layout.tail_tables()[0][lo - layout.tail_start:
                                                   hi - layout.tail_start]
            else:
                lo = w0
        cache[position] = SpanTables(position, w0, w1,
                                     tile_gid.astype(np.int64), lo - w0,
                                     tail_gid.astype(np.int64))
    return cache[position]


def _rows(x: torch.Tensor, lo: int, hi: int, width: int) -> torch.Tensor:
    return x[lo * width:hi * width].view(hi - lo, width)


def span_restore(dst: torch.Tensor, src: torch.Tensor, gid_mask: np.ndarray,
                 tables: SpanTables) -> None:
    """The words of the blocks ``gid_mask`` selects, from ``src`` into
    ``dst`` (two spans of one position), in place: masked_restore over the
    main-region tiles from the first selected to the last, then over the
    selected tail words' range."""
    from repro_torch.kernels.masked_restore.ops import masked_restore
    for gids, base, width in ((tables.tile_gid, 0, ARENA_TILE),
                              (tables.tail_gid, tables.tail_lo, 1)):
        sel = gid_mask[gids]
        hit = np.nonzero(sel)[0]
        if hit.size == 0:
            continue
        a, b = int(hit[0]), int(hit[-1]) + 1
        lo, hi = base // width + a, base // width + b
        rows = _rows(dst, lo, hi, width)
        mask = torch.from_numpy(sel[a:b].copy()).to(dst.device)
        rows.copy_(masked_restore(rows, _rows(src, lo, hi, width), mask, 1))


def span_block_sq(a: torch.Tensor, b: torch.Tensor, tables: SpanTables,
                  total_blocks: int) -> np.ndarray:
    """(total_blocks,) float64: this span's part of each block's squared
    distance between two spans of an all-f32 arena (block_dist per tile
    and per tail word, summed per block on the host in a fixed order)."""
    from repro_torch.kernels.block_dist.ops import block_dist
    out = np.zeros((total_blocks,), np.float64)
    for gids, base, width in ((tables.tile_gid, 0, ARENA_TILE),
                              (tables.tail_gid, tables.tail_lo, 1)):
        if gids.size == 0:
            continue
        lo = base // width
        d = block_dist(_rows(a, lo, lo + gids.size, width).view(torch.float32),
                       _rows(b, lo, lo + gids.size, width).view(torch.float32))
        out += np.bincount(gids, weights=d.double().cpu().numpy(),
                           minlength=total_blocks)
    return out


def mesh_block_sq(a: torch.Tensor, b: torch.Tensor, tables: SpanTables,
                  total_blocks: int, comm) -> np.ndarray:
    """Each block's squared distance over the whole mesh: the spans'
    parts (:func:`span_block_sq`) all-gathered and added in position
    order, the same float64 sums on every rank."""
    part = torch.from_numpy(span_block_sq(a, b, tables, total_blocks))
    parts = comm.all_gather(part.to(a.device)).view(comm.n, -1).cpu()
    out = parts[0].clone()
    for k in range(1, comm.n):
        out += parts[k]
    return out.numpy()


def restrict_reconstruct(plan, w0: int, w1: int, g0: int, g1: int,
                         frame_elems: int):
    """A reconstruct plan (:func:`~repro_torch.kernels.parity_xor.ops.
    reconstruct_plan`) cut to the arena words ``[w0, w1)`` and the parity
    rows ``[g0, g1)``: the terms that read the span (cut at its edges,
    their sources relative to it), the bases of the rows owned (relative
    to row ``g0``), zeros for the others. The XOR of every span's run of
    it is the plan's output."""
    from repro_torch.kernels.parity_xor.ops import ParityPlan
    n_rows = plan.row_out.size
    row_of = np.repeat(np.arange(n_rows), np.diff(plan.term_ptr))
    lo = np.maximum(plan.term_src, w0)
    hi = np.minimum(plan.term_src + plan.term_len, w1)
    keep = hi > lo
    group = np.where(plan.row_base >= 0, plan.row_base // frame_elems, -1)
    owned = (group >= g0) & (group < g1)
    return ParityPlan(
        row_out=plan.row_out, row_len=plan.row_len,
        row_base=np.where(owned, plan.row_base - g0 * frame_elems, -1),
        term_ptr=np.searchsorted(row_of[keep], np.arange(n_rows + 1)
                                 ).astype(np.int64),
        term_dst=(plan.term_dst + (lo - plan.term_src))[keep].astype(
            np.int32),
        term_src=(lo - w0)[keep].astype(np.int64),
        term_len=(hi - lo)[keep].astype(np.int32))


def word_routes(plan, blocks: np.ndarray, layout: ArenaLayout,
                n: int) -> list[np.ndarray]:
    """Where the output of a reconstruct plan goes: per position, the
    ``(out, length, word)`` rows (ascending ``out``) of the output words
    ``[out, out + length)`` that restore the arena words ``[word, word +
    length)`` of that position's span. Row ``r`` of the plan is arena
    block ``blocks[r]``'s payload."""
    sw = layout.shard_words
    offset = layout.ab_arrays()["offset"][blocks]
    routes: list[list] = [[] for _ in range(n)]
    for o, m, w in zip(plan.row_out.tolist(), plan.row_len.tolist(),
                       offset.tolist()):
        while m > 0:
            q = w // sw
            k = min(m, (q + 1) * sw - w)
            routes[q].append((o, k, w))
            o, m, w = o + k, m - k, w + k
    return [np.asarray(r, np.int64).reshape(-1, 3) for r in routes]


def span_reconstruct(dst: torch.Tensor, src: torch.Tensor,
                     owned: torch.Tensor, plan, blocks: np.ndarray,
                     layout: ArenaLayout, g0: int, g1: int,
                     frame_elems: int, comm) -> None:
    """Write the words a reconstruct plan rebuilds into the spans that
    hold them: this rank folds the terms that read its span of ``src``
    (the encode-time snapshot) with the parity rows ``[g0, g1)`` it owns
    (``owned``) into a partial of the plan's output; an all-to-all sends
    each partial word to the position whose span it restores; the ``n``
    partials a position receives are folded and written into ``dst``.
    Both folds are parity_xor launches. Every position of ``comm`` calls
    it with the same plan."""
    from repro_torch.kernels.parity_xor.ops import ParityPlan, parity_xor
    n, pos = comm.n, comm.pos
    w0 = pos * layout.shard_words
    part = torch.zeros((plan.out_words,), dtype=torch.int32,
                       device=dst.device)
    mine = restrict_reconstruct(plan, w0, w0 + layout.shard_words, g0, g1,
                                frame_elems)
    if mine.row_out.size:
        parity_xor(part, src, owned.reshape(-1), mine)
    routes = word_routes(plan, blocks, layout, n)
    counts = [int(r[:, 1].sum()) for r in routes]
    send = torch.cat([part[o:o + k] for r in routes for o, k, _ in r.tolist()]
                     or [part[:0]])
    recv = comm.all_to_all(send, counts, [counts[pos]] * n, max(counts))
    c = counts[pos]
    if c == 0:
        return
    words = torch.empty((c,), dtype=torch.int32, device=dst.device)
    fold = ParityPlan(
        row_out=np.zeros((1,), np.int64), row_len=np.asarray([c], np.int32),
        row_base=np.full((1,), -1, np.int64),
        term_ptr=np.asarray([0, n], np.int64),
        term_dst=np.zeros((n,), np.int32),
        term_src=np.arange(n, dtype=np.int64) * c,
        term_len=np.full((n,), c, np.int32))
    parity_xor(words, recv, None, fold)
    at = 0
    for _, k, w in routes[pos].tolist():
        dst[w - w0:w - w0 + k].copy_(words[at:at + k])
        at += k
