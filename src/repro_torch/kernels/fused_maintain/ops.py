"""Host side of the maintenance kernels: the arena sweep, the arena save, the
per-leaf sweep and the per-leaf in-place save.

- :class:`ArenaMaintainProgram` is the fabric's per-step maintenance over
  the flat arena: one arena_maintain launch yields the XOR parity (written
  straight into the codec's ``(n_groups, frame_elems)`` layout) and the
  per-block PRIORITY scores against the running checkpoint, and on the
  resident path the replica copy from the same read.
- :func:`arena_scatter_save` is the arena partial save: one arena_scatter
  launch for the selected tiles and tail words.
- :func:`make_fused_maintain_fn` is the per-leaf fabric's maintenance
  (``FabricConfig(arena=False)``, and trees the arena cannot pack): one
  fused_maintain launch per leaf yields the replica leaf, the leaf's
  per-block scores and its XOR parity folded into the codec's layout.
- :func:`tree_scatter_save` is the fabric-less in-place save
  (``FTController(inplace_save=True)``), one grouped scatter_save launch
  over the selected (leaf, block) pairs of the whole tree. Unlike the
  reference it needs no padding of k to a power of two (that bounded jit
  recompiles), but keeps its ``moved`` count.
- :func:`maintain_traffic` is the analytic bytes-moved model, equal to the
  reference's byte for byte.

Each ``ops`` function runs the CUDA kernel on CUDA tensors and the plain
version (``ref.py``) on CPU tensors. The host-side routing tables are
numpy, built with sorts and bincounts (no loop over tiles), so they stay
cheap at 1.5 M tiles.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.arena import (ARENA_TILE, ArenaLayout, as_live_arena,
                                    dtype_code, pack_arena)
from repro_torch.core.blocks import BlockPartition
from repro_torch.kernels.fused_maintain.kernel import (arena_maintain_cuda,
                                                       arena_scatter_cuda,
                                                       fused_maintain_cuda,
                                                       scatter_save_cuda,
                                                       scatter_save_tree_cuda)
from repro_torch.kernels.fused_maintain.ref import (arena_maintain_ref,
                                                    arena_scatter_ref,
                                                    fused_maintain_ref,
                                                    scatter_save_ref)
from repro_torch.kernels.leaf_table import leaf_arrays, save_pairs
from repro_torch.utils.tree import tree_flatten, tree_leaves, tree_unflatten

PyTree = Any


# ---------------------------------------------------------------------------
# Host-side group metadata (static per parity striping)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LeafGroupMeta:
    """Per-leaf routing tables of the per-leaf sweep (numpy)."""
    perm: np.ndarray        # (S,) block ids sorted by parity group
    outrow: np.ndarray      # (S,) compact parity row per sorted position
    first: np.ndarray       # (S,) 1 at the first sorted position of its row
    touched: np.ndarray     # (n_out,) global group ids, ascending
    members: np.ndarray     # (n_out, m_hat) local block ids, -1 padded
    col: int                # column of this leaf's payload in the frame
    width: int              # payload width (int32 words)


def _members_table(rows: np.ndarray, ids: np.ndarray,
                   n_rows: int) -> np.ndarray:
    """(n_rows, m_hat) table of ``ids`` by ascending ``rows`` (sorted), in
    order within a row, -1 padded: one bincount, no loop."""
    counts = np.bincount(rows, minlength=n_rows)
    m_hat = int(counts.max()) if counts.size else 0
    out = np.full((n_rows, m_hat), -1, np.int32)
    if rows.size:
        rank = np.arange(rows.size) - (np.cumsum(counts) - counts)[rows]
        out[rows, rank] = ids
    return out


def leaf_group_metas(partition: BlockPartition, layout,
                     group_of: np.ndarray) -> list[LeafGroupMeta]:
    """Each leaf's routing tables from the codec's group assignment."""
    group_of = np.asarray(group_of, np.int32)
    metas = []
    for leaf, col, width in zip(partition.leaves, layout.cols, layout.widths):
        gids = group_of[leaf.offset:leaf.offset + leaf.n_blocks]
        if (gids < 0).any():
            raise ValueError(f"leaf {leaf.name}: blocks outside any parity "
                             f"group")
        order = np.argsort(gids, kind="stable").astype(np.int32)
        touched, inverse = np.unique(gids, return_inverse=True)
        outrow = inverse.astype(np.int32)[order]
        first = np.ones_like(outrow)
        first[1:] = (outrow[1:] != outrow[:-1]).astype(np.int32)
        metas.append(LeafGroupMeta(
            perm=order, outrow=outrow, first=first,
            touched=touched.astype(np.int32),
            members=_members_table(outrow, order, touched.size),
            col=int(col), width=int(width)))
    return metas


def leaf_tables(meta: LeafGroupMeta, n_blocks: int,
                device: torch.device) -> dict:
    """A leaf's routing tables as the per-leaf sweep takes them: the
    ``members`` rows and their ``touched`` groups on ``device``, with the
    ints ``n_out``, ``m_hat``, ``width``, ``n_blocks`` and
    ``max_touched``."""
    members = np.ascontiguousarray(meta.members, np.int32)
    return {"members": torch.from_numpy(members.reshape(-1)).to(device),
            "touched": torch.from_numpy(
                np.ascontiguousarray(meta.touched, np.int32)).to(device),
            "n_out": int(members.shape[0]), "m_hat": int(members.shape[1]),
            "width": int(meta.width), "n_blocks": int(n_blocks),
            "max_touched": int(meta.touched.max()) if meta.touched.size
            else -1}


def fused_maintain(x: torch.Tensor, z, parity, t: dict, block_rows: int,
                   col: int, frame_elems: int, replica=None):
    """One leaf's sweep: ``(replica, scores)``, the parity folded in place.
    The kernel on CUDA leaves (it raises on a dtype it does not take), the
    plain version on CPU leaves."""
    if z is not None and z.dtype != x.dtype:
        z = z.to(x.dtype)
    if x.device.type == "cpu":
        return fused_maintain_ref(x, z, parity, t, block_rows, col,
                                  frame_elems, replica)
    return fused_maintain_cuda(
        x.contiguous(), None if z is None else z.contiguous(), parity, t,
        block_rows, col, frame_elems, replica)


def make_fused_maintain_fn(partition: BlockPartition, layout,
                           group_of: np.ndarray, n_groups: int,
                           parity: bool = True):
    """The per-leaf single-sweep maintenance program.

    Returns ``fn(params, ckpt_values=None) -> (replica_tree, scores,
    parity)``: ``scores`` the (total_blocks,) squared-L2 drift against the
    running checkpoint (colocated leaves accumulate, as ``block_scores``;
    zeros without ``ckpt_values``), ``parity`` the ``(n_groups,
    frame_elems)`` int32 XOR parity, bit-identical to
    ``ParityCodec.encode`` under the same striping (a new buffer each call,
    zeroed once and folded into leaf by leaf). ``parity=False`` skips it
    (the RS codec encodes its own rows) and returns None for it. One
    fused_maintain launch per leaf on the card."""
    metas = leaf_group_metas(partition, layout, group_of)
    br = partition.block_rows
    fe = layout.frame_elems
    tables: dict[str, list] = {}

    def fn(params: PyTree, ckpt_values: Optional[PyTree] = None):
        flat, treedef = tree_flatten(params)
        zflat = (tree_leaves(ckpt_values) if ckpt_values is not None
                 else [None] * len(flat))
        dev = flat[0].device
        ts = tables.get(str(dev))
        if ts is None:
            ts = tables[str(dev)] = [leaf_tables(m, l.n_blocks, dev)
                                     for m, l in zip(metas,
                                                     partition.leaves)]
        scores = torch.zeros((partition.total_blocks,), dtype=torch.float32,
                             device=dev)
        par = (torch.zeros((n_groups * fe,), dtype=torch.int32, device=dev)
               if parity else None)
        reps = []
        for x, z, leaf, meta, t in zip(flat, zflat, partition.leaves, metas,
                                       ts):
            rep, sc = fused_maintain(x, z, par, t, br, meta.col, fe)
            reps.append(rep)
            if sc is not None:
                scores[leaf.offset:leaf.offset + leaf.n_blocks] += sc
        return (tree_unflatten(treedef, reps), scores,
                None if par is None else par.view(n_groups, fe))

    return fn


# ---------------------------------------------------------------------------
# Arena routing and the sweep plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ArenaRouting:
    """Host-side tile routing of the arena sweep (static per striping),
    the reference's tables."""
    perm: np.ndarray          # (T,) arena tile visited at sorted step s
    dest: np.ndarray          # (T,) compact parity tile per sorted step
    first: np.ndarray         # (T,) 1 at the first step of its dest
    touched: np.ndarray       # (n_dest,) full parity tile index, ascending
    members: np.ndarray       # (n_dest, m_hat) arena tile ids, -1 padded
    tile_gid: np.ndarray      # (T,) global block id per arena tile
    frame_tiles: int          # parity frame width in arena tiles


def arena_routing(arena_layout: ArenaLayout, frame_layout,
                  group_of: np.ndarray) -> ArenaRouting:
    """Map every main-region tile to its parity destination tile.

    Tile ``k`` of block ``gid`` (leaf ``l``) lands in parity frame row
    ``group_of[gid]`` at columns ``cols[l] + k * ARENA_TILE``: whole tiles,
    because the frame layout is tile-aligned. Tail-region blocks (word
    granular, tile-sharing) are routed word by word by :func:`sweep_plan`.
    """
    group_of = np.asarray(group_of, np.int32)
    ab = arena_layout.ab_arrays()
    if (group_of[ab["gid"]] < 0).any():
        raise ValueError("arena blocks outside any parity group")
    ftiles = frame_layout.frame_elems // ARENA_TILE
    n_tiles = arena_layout.n_tiles
    tiles, abi = arena_layout.main_tiles()
    k = tiles - arena_layout.ab_t0[abi]
    col_t = np.asarray(frame_layout.cols, np.int64)[ab["leaf"][abi]] \
        // ARENA_TILE
    dest_full = np.full((n_tiles,), -1, np.int64)
    dest_full[tiles] = group_of[ab["gid"][abi]] * ftiles + col_t + k
    tile_gid = np.zeros((n_tiles,), np.int32)
    tile_gid[tiles] = ab["gid"][abi]
    data_tiles = np.nonzero(dest_full >= 0)[0]
    perm = data_tiles[np.argsort(dest_full[data_tiles],
                                 kind="stable")].astype(np.int32)
    touched, inverse = np.unique(dest_full[perm], return_inverse=True)
    dest = inverse.astype(np.int32)
    first = np.ones_like(dest)
    first[1:] = (dest[1:] != dest[:-1]).astype(np.int32)
    return ArenaRouting(perm=perm, dest=dest, first=first,
                        touched=touched.astype(np.int32),
                        members=_members_table(dest, perm, touched.size),
                        tile_gid=tile_gid, frame_tiles=int(ftiles))


@dataclasses.dataclass(eq=False)
class SweepPlan:
    """The arena_maintain kernel's tables (numpy), built by
    :func:`sweep_plan`. Destination ``d`` (one warp on the card) writes
    parity tile ``dest_tile[d]`` from its member tiles
    ``mem_tile[mem_ptr[d]:mem_ptr[d + 1]]`` and its tail words
    ``(tail_pos, tail_word)[tail_ptr[d]:tail_ptr[d + 1]]``; tail block
    ``j`` (words ``[tb_off[j], tb_off[j] + tb_len[j])``) is one score part;
    gid ``g`` sums the parts of its arena blocks ``gid_ab[gid_ptr[g]:
    gid_ptr[g + 1]]``, block ``a`` owning parts ``[ab_seg0[a], ab_seg0[a] +
    ab_nseg[a])`` (its tiles, or ``n_tiles`` + its tail-block index)."""
    n_tiles: int
    tile_code: np.ndarray
    dest_tile: np.ndarray
    mem_ptr: np.ndarray
    mem_tile: np.ndarray
    tail_ptr: np.ndarray
    tail_pos: np.ndarray
    tail_word: np.ndarray
    tb_off: np.ndarray
    tb_len: np.ndarray
    tb_code: np.ndarray
    gid_ptr: np.ndarray
    gid_ab: np.ndarray
    ab_seg0: np.ndarray
    ab_nseg: np.ndarray

    def __post_init__(self):
        self._on: dict[str, dict] = {}

    def on(self, device: torch.device) -> dict:
        """The tables as tensors on ``device`` (uploaded once), plus the
        ints ``n_tiles``, ``max_code`` and ``max_dest_tile``."""
        key = str(device)
        t = self._on.get(key)
        if t is None:
            t = {f.name: torch.from_numpy(np.ascontiguousarray(
                     getattr(self, f.name))).to(device)
                 for f in dataclasses.fields(self) if f.name != "n_tiles"}
            codes = np.concatenate([self.tile_code, self.tb_code, [0]])
            t.update(n_tiles=self.n_tiles, max_code=int(codes.max()),
                     max_dest_tile=int(self.dest_tile.max())
                     if self.dest_tile.size else -1)
            self._on[key] = t
        return t


def sweep_plan(layout: ArenaLayout, frame_layout=None, group_of=None,
               routing: Optional[ArenaRouting] = None) -> SweepPlan:
    """The sweep's tables for ``layout``. With ``frame_layout`` and
    ``group_of`` the destinations are the parity tiles (main-region tiles
    routed by :func:`arena_routing`, tail words by their flat parity
    position ``group * frame_elems + col + j``); without them every
    main-region tile is its own destination and nothing is written but
    scores (the plan of :func:`repro_torch.core.arena.arena_drift_scores`).
    """
    ab = layout.ab_arrays()
    tail_ab = np.nonzero(ab["offset"] >= layout.tail_start)[0]
    leaf_code = np.asarray([dtype_code(l.dtype)
                            for l in layout.partition.leaves], np.int8)
    if frame_layout is None:
        n_main = layout.tail_start // ARENA_TILE
        dest_tile = np.arange(n_main, dtype=np.int32)
        mem_ptr = np.arange(n_main + 1, dtype=np.int64)
        mem_tile = dest_tile
        tail_ptr = np.zeros((n_main + 1,), np.int64)
        tail_pos = np.empty((0,), np.int32)
        tail_word = np.empty((0,), np.int64)
    else:
        r = routing if routing is not None else \
            arena_routing(layout, frame_layout, group_of)
        gof = np.asarray(group_of, np.int64)
        fe = frame_layout.frame_elems
        cols = np.asarray(frame_layout.cols, np.int64)
        n = ab["payload"][tail_ab]
        within = np.arange(int(n.sum())) - np.repeat(np.cumsum(n) - n, n)
        pos = np.repeat(gof[ab["gid"][tail_ab]] * fe
                        + cols[ab["leaf"][tail_ab]], n) + within
        words = np.repeat(ab["offset"][tail_ab], n) + within
        order = np.argsort(pos, kind="stable")
        pos, words = pos[order], words[order]
        dest = np.union1d(r.touched.astype(np.int64), pos // ARENA_TILE)
        dest_tile = dest.astype(np.int32)
        mem_counts = np.zeros((dest.size,), np.int64)
        mem_counts[np.searchsorted(dest, r.touched)] = np.bincount(
            r.dest, minlength=r.touched.size)
        mem_ptr = np.concatenate([[0], np.cumsum(mem_counts)])
        mem_tile = r.perm
        tail_counts = np.bincount(np.searchsorted(dest, pos // ARENA_TILE),
                                  minlength=dest.size)
        tail_ptr = np.concatenate([[0], np.cumsum(tail_counts)])
        tail_pos = (pos % ARENA_TILE).astype(np.int32)
        tail_word = words.astype(np.int64)
    ab_seg0 = layout.ab_t0.astype(np.int64).copy()
    ab_nseg = (ab["words"] // ARENA_TILE).astype(np.int32)
    ab_seg0[tail_ab] = layout.n_tiles + np.arange(tail_ab.size)
    ab_nseg[tail_ab] = 1
    return SweepPlan(
        n_tiles=layout.n_tiles, tile_code=layout.tile_codes(),
        dest_tile=dest_tile, mem_ptr=mem_ptr.astype(np.int64),
        mem_tile=mem_tile.astype(np.int32), tail_ptr=tail_ptr.astype(np.int64),
        tail_pos=tail_pos, tail_word=tail_word,
        tb_off=ab["offset"][tail_ab].astype(np.int64),
        tb_len=ab["payload"][tail_ab].astype(np.int32),
        tb_code=leaf_code[ab["leaf"][tail_ab]],
        gid_ptr=layout.gid_ptr.astype(np.int64),
        gid_ab=layout.gid_ab.astype(np.int32),
        ab_seg0=ab_seg0, ab_nseg=ab_nseg)


def arena_sweep(x: torch.Tensor, z: Optional[torch.Tensor], plan: SweepPlan,
                parity: Optional[torch.Tensor] = None,
                replica: Optional[torch.Tensor] = None):
    """One arena sweep under ``plan``: writes ``parity`` and ``replica``
    (when given) in place and returns the (total_blocks,) f32 scores of
    ``x`` against ``z`` (None without ``z``). The plain version for CPU
    tensors, the arena_maintain kernel otherwise."""
    t = plan.on(x.device)
    if x.device.type == "cpu":
        return arena_maintain_ref(x, z, t, parity, replica)
    return arena_maintain_cuda(x, z, t, parity, replica)


def score_plan(layout: ArenaLayout) -> SweepPlan:
    """The sweep plan with no parity destinations (every main-region tile
    its own destination), built once per layout: the plan of
    :func:`repro_torch.core.arena.arena_drift_scores` and of the RS
    fabric's sweep."""
    plan = getattr(layout, "_score_plan", None)
    if plan is None:
        plan = sweep_plan(layout)
        object.__setattr__(layout, "_score_plan", plan)
    return plan


class ArenaMaintainProgram:
    """The single-sweep maintenance program over the flat arena.

    ``program(params, ckpt_arena, own_live)`` returns ``(replica_arena,
    scores, parity)``: parity bit-identical to the reference's
    ``ParityCodec.encode`` under the same striping, scores allclose to
    ``block_scores`` under the l2 norm (another summation order; quantized
    words decoded by dtype), zeros without ``ckpt_arena``.

    ``params`` may be a tree (packed here: the pack is the replica write),
    the live arena itself with ``own_live`` (it becomes the replica: no
    copy), or the live arena without it (the resident path: the kernel
    writes the replica copy from the same read; the few unrouted
    tail-region words are copied after it).

    The parity is one buffer per program, zeroed once when the program is
    built for a striping; every sweep rewrites every tile a destination
    owns, and the tiles none owns are frame padding, zero for good. (The
    reference allocates a new one each sweep.) The tensor returned is that
    buffer: the next sweep of this program overwrites it.

    Without ``frame_layout`` the program has no parity destinations (the
    RS codec encodes its own rows from the replica): the sweep runs the
    score plan (:func:`score_plan`) for the scores and the resident copy,
    returns None for the parity, and is skipped when it has nothing to
    write."""

    def __init__(self, partition: BlockPartition, arena_layout: ArenaLayout,
                 frame_layout=None, group_of: Optional[np.ndarray] = None,
                 n_groups: int = 0):
        self.layout = arena_layout
        self.total = partition.total_blocks
        if frame_layout is None:
            self.routing = None
            self.plan = score_plan(arena_layout)
            self.shape = None
        else:
            self.routing = arena_routing(arena_layout, frame_layout,
                                         group_of)
            self.plan = sweep_plan(arena_layout, frame_layout, group_of,
                                   routing=self.routing)
            self.shape = (n_groups, frame_layout.frame_elems)
        self._parity: Optional[torch.Tensor] = None

    def parity_buffer(self, device: torch.device) -> Optional[torch.Tensor]:
        if self.shape is None:
            return None
        if self._parity is None or self._parity.device != device:
            self._parity = torch.zeros(self.shape, dtype=torch.int32,
                                       device=device)
        return self._parity

    def __call__(self, params: PyTree, ckpt_arena=None,
                 own_live: bool = False):
        live = as_live_arena(params, self.layout)
        copy = None
        if live is None:
            rep = pack_arena(params, self.layout)
        else:
            rep = live
            if not own_live:
                copy = torch.empty_like(live)
        parity = self.parity_buffer(rep.device)
        scores = None
        if parity is not None or ckpt_arena is not None or copy is not None:
            scores = arena_sweep(
                rep, ckpt_arena, self.plan,
                parity=None if parity is None else parity.view(-1),
                replica=copy)
        if copy is not None:
            copy[self.layout.tail_start:] = live[self.layout.tail_start:]
            rep = copy
        if scores is None:
            scores = torch.zeros((self.total,), dtype=torch.float32,
                                 device=rep.device)
        return rep, scores, parity


# ---------------------------------------------------------------------------
# The sweep of one shard on a mesh
# ---------------------------------------------------------------------------

def restrict_plan(plan: SweepPlan, layout: ArenaLayout, t0: int,
                  t1: int) -> tuple[SweepPlan, np.ndarray]:
    """``plan`` cut to the arena tiles ``[t0, t1)``, every index relative
    to the span (the kernel reads the span as its arena): the member tiles
    and tail words that lie there, the destinations they reach (numbered
    0.. in the order of ``plan``'s ascending destinations, so the parity it
    writes is a compact buffer of those tiles), the tail blocks' parts
    inside the span, and each arena block's score segments there (none for
    a block outside it; the scores of a block that straddles the span's
    edge are partial, and the ranks' sum is the block's score). Returns
    the plan and each compact destination's tile in ``plan``'s parity.
    Over ``[0, n_tiles)`` every table but the destinations' numbering is
    ``plan``'s."""
    T = ARENA_TILE
    w0, w1 = t0 * T, t1 * T
    n_dest = plan.dest_tile.size
    mcount = np.diff(plan.mem_ptr)
    m_dest = np.repeat(np.arange(n_dest), mcount)
    keep_m = (plan.mem_tile >= t0) & (plan.mem_tile < t1)
    tcount = np.diff(plan.tail_ptr)
    t_dest = np.repeat(np.arange(n_dest), tcount)
    keep_t = (plan.tail_word >= w0) & (plan.tail_word < w1)
    mem_n = np.bincount(m_dest[keep_m], minlength=n_dest)
    tail_n = np.bincount(t_dest[keep_t], minlength=n_dest)
    dests = np.nonzero((mem_n + tail_n) > 0)[0]
    ab = layout.ab_arrays()
    tail_ab = np.nonzero(ab["offset"] >= layout.tail_start)[0]
    lo = np.maximum(plan.tb_off, w0)
    hi = np.minimum(plan.tb_off + plan.tb_len, w1)
    keep_b = hi > lo
    n_loc = t1 - t0
    main_nseg = (ab["words"] // T).astype(np.int64)
    s0 = np.clip(layout.ab_t0, t0, t1)
    s1 = np.clip(layout.ab_t0 + main_nseg, t0, t1)
    ab_seg0 = (s0 - t0).astype(np.int64)
    ab_nseg = (s1 - s0).astype(np.int32)
    tb_local = np.cumsum(keep_b) - 1
    ab_seg0[tail_ab] = n_loc + np.where(keep_b, tb_local, 0)
    ab_nseg[tail_ab] = keep_b.astype(np.int32)
    out = SweepPlan(
        n_tiles=n_loc, tile_code=plan.tile_code[t0:t1],
        dest_tile=np.arange(dests.size, dtype=np.int32),
        mem_ptr=np.concatenate([[0], np.cumsum(mem_n[dests])]
                               ).astype(np.int64),
        mem_tile=(plan.mem_tile[keep_m] - t0).astype(np.int32),
        tail_ptr=np.concatenate([[0], np.cumsum(tail_n[dests])]
                                ).astype(np.int64),
        tail_pos=plan.tail_pos[keep_t],
        tail_word=(plan.tail_word[keep_t] - w0).astype(np.int64),
        tb_off=(lo - w0)[keep_b].astype(np.int64),
        tb_len=(hi - lo)[keep_b].astype(np.int32),
        tb_code=plan.tb_code[keep_b],
        gid_ptr=plan.gid_ptr, gid_ab=plan.gid_ab,
        ab_seg0=ab_seg0, ab_nseg=ab_nseg)
    return out, plan.dest_tile[dests].astype(np.int64)


def span_destinations(plan: SweepPlan, tiles_per: int,
                      n: int) -> list[np.ndarray]:
    """The ascending parity tiles of ``plan`` that the sweep of each of
    ``n`` spans of ``tiles_per`` tiles writes (what :func:`restrict_plan`
    returns as destinations, for every span at once)."""
    n_dest = plan.dest_tile.size
    m_dest = np.repeat(np.arange(n_dest), np.diff(plan.mem_ptr))
    t_dest = np.repeat(np.arange(n_dest), np.diff(plan.tail_ptr))
    span = np.concatenate([plan.mem_tile // tiles_per,
                           plan.tail_word // (tiles_per * ARENA_TILE)])
    dest = np.concatenate([m_dest, t_dest])
    key = np.unique(span.astype(np.int64) * n_dest + dest)
    sp, d = key // n_dest, key % n_dest
    bounds = np.searchsorted(sp, np.arange(n + 1))
    return [plan.dest_tile[d[bounds[k]:bounds[k + 1]]].astype(np.int64)
            for k in range(n)]


def combine_plan(dests: list[np.ndarray], owner: int, rows_per: int,
                 frame_tiles: int):
    """The parity_xor plan of the XOR combine at position ``owner``: its
    parity rows ``[owner * rows_per, (owner + 1) * rows_per)`` (one plan
    row each, ``frame_tiles`` tiles wide, base zeros) XOR the tiles every
    position sent it, laid out back to back in position order, each
    position's in ascending tile order (``dests[k]``: position ``k``'s
    destinations). Consecutive tiles of one position and one row are one
    term. Returns the plan and the tiles each position sends to each
    (``counts[k][r]``)."""
    from repro_torch.kernels.parity_xor.ops import ParityPlan
    T = ARENA_TILE
    n = len(dests)
    counts = np.zeros((n, n), np.int64)
    srcs, tiles, ks = [], [], []
    base = 0
    for k, d in enumerate(dests):
        o = d // frame_tiles // rows_per
        counts[k] = np.bincount(o, minlength=n)[:n]
        mine = d[o == owner]
        srcs.append(base + np.arange(mine.size))
        tiles.append(mine)
        ks.append(np.full(mine.size, k))
        base += mine.size
    src = np.concatenate(srcs) if srcs else np.empty((0,), np.int64)
    tile = np.concatenate(tiles) if tiles else np.empty((0,), np.int64)
    k_of = np.concatenate(ks) if ks else np.empty((0,), np.int64)
    row = tile // frame_tiles - owner * rows_per
    col = tile % frame_tiles
    order = np.lexsort((col, k_of, row))
    row, col, src, k_of = row[order], col[order], src[order], k_of[order]
    new = np.ones(row.size, bool)
    new[1:] = ((row[1:] != row[:-1]) | (k_of[1:] != k_of[:-1])
               | (col[1:] != col[:-1] + 1) | (src[1:] != src[:-1] + 1))
    starts = np.nonzero(new)[0]
    lens = np.diff(np.concatenate([starts, [row.size]]))
    t_row = row[starts]
    fe = frame_tiles * T
    plan = ParityPlan(
        row_out=np.arange(rows_per, dtype=np.int64) * fe,
        row_len=np.full(rows_per, fe, np.int32),
        row_base=np.full(rows_per, -1, np.int64),
        term_ptr=np.searchsorted(t_row, np.arange(rows_per + 1)
                                 ).astype(np.int64),
        term_dst=(col[starts] * T).astype(np.int32),
        term_src=(src[starts] * T).astype(np.int64),
        term_len=(lens * T).astype(np.int32))
    return plan, counts


class SpanMaintainProgram:
    """The arena sweep of position ``position`` of ``n`` on a mesh.

    The rank holds the span ``layout.span(position)`` of every arena.
    ``program(span, ckpt_span, comm, copy)`` runs the arena_maintain kernel
    over the span's tiles only (:func:`restrict_plan`): it writes this
    rank's partial parity, the XOR of the span's words at each parity tile
    they reach, as a compact buffer of those tiles, this span's score
    partials, and, with ``copy``, a replica copy of the span from the same
    read. Then the **XOR combine**: one all-to-all sends each partial tile
    to the position that owns its parity row, and the parity_xor kernel
    folds what each owner received into its rows. Parity rows are owned by
    position: position ``r`` holds the rows ``[r * rows_per, (r + 1) *
    rows_per)`` (``rows_per = ceil(n_groups / n)``; a last owner's rows
    past ``n_groups`` stay zero), so the parity costs its size once over
    the mesh, not on every rank. The per-block scores are summed over the
    mesh (a block straddling a span edge has a part on each side).

    Returns ``(replica_span or None, scores, owned_rows)``; the owned rows
    are one buffer per program, rewritten by every sweep."""

    def __init__(self, partition: BlockPartition, arena_layout: ArenaLayout,
                 frame_layout, group_of: np.ndarray, n_groups: int,
                 position: int, n: int):
        if arena_layout.shards != n:
            raise ValueError(f"a {arena_layout.shards}-shard layout on a "
                             f"{n}-position mesh")
        self.layout = arena_layout
        self.total = partition.total_blocks
        self.position, self.n = position, n
        full = sweep_plan(arena_layout, frame_layout, group_of)
        tiles_per = arena_layout.n_tiles // n
        t0 = position * tiles_per
        self.plan, self.dest_full = restrict_plan(full, arena_layout, t0,
                                                  t0 + tiles_per)
        self.frame_elems = frame_layout.frame_elems
        self.n_groups = n_groups
        self.rows_per = -(-n_groups // n)
        self.combine, counts = combine_plan(
            span_destinations(full, tiles_per, n), position, self.rows_per,
            self.frame_elems // ARENA_TILE)
        self.send_counts = counts[position] * ARENA_TILE
        self.recv_counts = counts[:, position] * ARENA_TILE
        self.max_count = int(counts.max(initial=0)) * ARENA_TILE
        self._partial: Optional[torch.Tensor] = None
        self._owned: Optional[torch.Tensor] = None

    def row_range(self, position: Optional[int] = None) -> tuple[int, int]:
        """The parity rows ``[g0, g1)`` a position owns (this one's by
        default), cut at ``n_groups``."""
        p = self.position if position is None else position
        return (min(p * self.rows_per, self.n_groups),
                min((p + 1) * self.rows_per, self.n_groups))

    def buffers(self, device: torch.device):
        if self._owned is None or self._owned.device != device:
            self._partial = torch.zeros(
                (max(self.dest_full.size, 1) * ARENA_TILE,),
                dtype=torch.int32, device=device)
            self._owned = torch.zeros((self.rows_per * self.frame_elems,),
                                      dtype=torch.int32, device=device)
        return self._partial, self._owned

    def __call__(self, span: torch.Tensor, ckpt_span, comm,
                 copy: bool = False):
        from repro_torch.kernels.parity_xor.ops import parity_xor
        partial, owned = self.buffers(span.device)
        rep = torch.empty_like(span) if copy else None
        scores = arena_sweep(span, ckpt_span, self.plan, parity=partial,
                             replica=rep)
        if rep is not None:
            tail = max(self.layout.tail_start
                       - self.position * self.layout.shard_words, 0)
            rep[tail:] = span[tail:]
        recv = comm.all_to_all(partial[:self.dest_full.size * ARENA_TILE],
                               self.send_counts, self.recv_counts,
                               self.max_count)
        parity_xor(owned, recv, None, self.combine)
        if scores is None:
            scores = torch.zeros((self.total,), dtype=torch.float32,
                                 device=span.device)
        else:
            comm.all_reduce(scores)
        return rep, scores, owned.view(self.rows_per, self.frame_elems)


# ---------------------------------------------------------------------------
# Arena in-place partial save: one launch for the whole model
# ---------------------------------------------------------------------------

def scatter_plan(off: np.ndarray, length: np.ndarray,
                 device: torch.device) -> dict:
    """The arena_scatter kernel's tables for the word ranges ``[off,
    off + length)`` (disjoint, non-empty), on ``device``: the ranges, the
    prefix sum of their 4 KB chunks, and each chunk's range (one CTA per
    chunk on the card)."""
    off = np.asarray(off, np.int64)
    length = np.asarray(length, np.int32)
    if off.shape != length.shape or off.ndim != 1 \
            or (off.size and (off.min() < 0 or length.min() < 1)):
        raise ValueError("ranges must be 1-D, non-empty and non-negative")
    chunks = (length.astype(np.int64) + 1023) // 1024
    chunk_ptr = np.concatenate([[0], np.cumsum(chunks)]).astype(np.int64)
    if chunk_ptr[-1] >= 2**31:
        raise ValueError(f"{chunk_ptr[-1]} chunks exceed the grid")
    chunk_range = np.repeat(np.arange(off.size, dtype=np.int32), chunks)
    t64 = torch.from_numpy(np.concatenate([off, chunk_ptr])).to(device)
    t32 = torch.from_numpy(np.concatenate([length, chunk_range])).to(device)
    return {"off": t64[:off.size], "chunk_ptr": t64[off.size:],
            "len": t32[:off.size], "chunk_range": t32[off.size:],
            "end_word": int((off + length).max()) if off.size else 0}


def arena_scatter(dst: torch.Tensor, src: torch.Tensor,
                  t: dict) -> torch.Tensor:
    """Copy the word ranges of the plan ``t`` from ``src`` into ``dst`` in
    place: the plain version for CPU tensors, the kernel otherwise."""
    if dst.device.type == "cpu":
        return arena_scatter_ref(dst, src, t)
    return arena_scatter_cuda(dst, src, t)


def save_ranges(arena_layout: ArenaLayout,
                global_idx) -> tuple[np.ndarray, np.ndarray]:
    """The word ranges a save of these gids copies: each main-region block's
    whole tiles (its own; no two blocks share one) and each tail-packed
    block's payload words. ``(offsets int64, lengths int32)``."""
    main, tail = arena_layout.split_tail_blocks(global_idx)
    ab = arena_layout.ab_arrays()
    off = np.concatenate([arena_layout.ab_t0[main] * ARENA_TILE,
                          ab["offset"][tail]]).astype(np.int64)
    length = np.concatenate([arena_layout.ab_nt[main] * ARENA_TILE,
                             ab["payload"][tail]]).astype(np.int32)
    return off, length


def arena_scatter_save(dst_arena: torch.Tensor, src_arena: torch.Tensor,
                       arena_layout: ArenaLayout, global_idx,
                       span: Optional[tuple[int, int]] = None
                       ) -> tuple[torch.Tensor, int]:
    """Overwrite the selected blocks' arena segments of ``dst_arena`` from
    ``src_arena`` in place, in one arena_scatter launch over
    :func:`save_ranges`. ``global_idx``: host-side selected gids
    (colocated segments ride along). Returns ``(dst_arena, bytes_moved)``,
    the bytes equal to ``seg_bytes_for_blocks``. With ``span = (w0,
    w1)`` both arenas are that span of the arena (a rank's shard on a
    mesh): the ranges are cut to it, and the bytes are the span's share."""
    off, length = save_ranges(arena_layout, global_idx)
    if span is not None:
        w0, w1 = span
        lo = np.maximum(off, w0)
        hi = np.minimum(off + length, w1)
        keep = hi > lo
        off, length = (lo[keep] - w0).astype(np.int64), \
            (hi - lo)[keep].astype(np.int32)
    if off.size:
        arena_scatter(dst_arena, src_arena,
                      scatter_plan(off, length, dst_arena.device))
    return dst_arena, 4 * int(length.sum())


# ---------------------------------------------------------------------------
# In-place partial save of a tree
# ---------------------------------------------------------------------------

def scatter_save(dst: torch.Tensor, src: torch.Tensor, rows: torch.Tensor,
                 block_rows: int) -> torch.Tensor:
    """In-place block scatter over a (R, W) row matrix: the plain version
    for CPU tensors, the CUDA kernel otherwise."""
    if dst.device.type == "cpu":
        return scatter_save_ref(dst, src, rows, block_rows)
    return scatter_save_cuda(dst, src, rows, block_rows)


def tree_scatter_save(dst: PyTree, src: PyTree, global_idx,
                      partition: BlockPartition) -> tuple[PyTree, int]:
    """Overwrite the selected blocks of ``dst`` from ``src`` in place.

    ``global_idx``: host-side selected global block ids. Leaves with no
    selected block are not touched; colocated leaves each copy their own
    payload for the shared ids. On CUDA leaves this is one grouped
    scatter_save launch over the selected (leaf, block) pairs; on CPU
    leaves the plain version, leaf by leaf. Returns ``(dst, bytes_moved)``.
    """
    idx = np.unique(np.asarray(global_idx, np.int64))
    if idx.size and (idx[0] < 0 or idx[-1] >= partition.total_blocks):
        raise IndexError(f"block ids must lie in [0, "
                         f"{partition.total_blocks})")
    dst_flat, src_flat = tree_leaves(dst), tree_leaves(src)
    leaf, block = save_pairs(idx, partition)
    if leaf.size == 0:
        return dst, 0
    br = partition.block_rows
    g = leaf_arrays(partition)
    rows_per = np.minimum((block + 1) * br, g.rows[leaf]) - block * br
    moved = int((rows_per.clip(min=0) * g.row_width[leaf]
                 * g.itemsize[leaf]).sum())
    if dst_flat[int(leaf[0])].device.type != "cpu":
        scatter_save_tree_cuda(dst_flat, src_flat, leaf, block, partition)
        return dst, moved
    bounds = np.flatnonzero(np.diff(leaf)) + 1
    touched = leaf[np.concatenate([[0], bounds])].tolist()
    for l, sel in zip(touched, np.split(block, bounds)):
        d, s, meta = dst_flat[l], src_flat[l], partition.leaves[l]
        if not d.is_contiguous():
            raise ValueError(f"checkpoint leaf {meta.name} is not "
                             f"contiguous; an in-place save needs it so")
        rows, width = meta.rows, meta.row_width
        scatter_save_ref(d.view(rows, width),
                         s.to(d.dtype).reshape(rows, width).contiguous(),
                         torch.from_numpy(sel.astype(np.int32)), br)
    return dst, moved


# ---------------------------------------------------------------------------
# Analytic traffic model (bytes per maintain step)
# ---------------------------------------------------------------------------

def _tree_nbytes(partition: BlockPartition) -> int:
    return sum(int(np.prod(l.shape) or 1) * l.dtype.itemsize
               for l in partition.leaves)


def maintain_traffic(partition: BlockPartition, layout, group_of: np.ndarray,
                     n_groups: int, group_width: int,
                     arena_layout: Optional[ArenaLayout] = None
                     ) -> dict[str, int]:
    """Analytic HBM bytes moved by one full maintenance step (replica
    refresh + parity encode + priority scoring), the reference's model
    term for term: the seed path, the per-leaf fused path and, with
    ``arena_layout``, the arena paths (internal pack, resident, owned,
    async, sharded). The port's own sweep moves fewer bytes than the
    ``arena`` terms (it writes no compact tiles), but the counts here are
    kept equal to the reference's so the two packages' accounting
    compares directly."""
    model = _tree_nbytes(partition)
    frames = partition.total_blocks * layout.frame_elems * 4
    gathered = n_groups * group_width * layout.frame_elems * 4
    parity = n_groups * layout.frame_elems * 4
    metas = leaf_group_metas(partition, layout, group_of)
    contrib = sum(m.touched.size * m.width * 4 for m in metas)
    seed = (model + model + model + frames + frames + gathered
            + gathered + parity + model + model)
    fused = model + model + model + contrib + 2 * contrib + parity
    out = {"seed": int(seed), "fused": int(fused), "model": int(model),
           "parity": int(parity), "staging_seed": int(frames + gathered),
           "staging_fused": int(contrib)}
    if arena_layout is not None:
        a = arena_layout.nbytes
        r = arena_routing(arena_layout, layout, group_of)
        ab = arena_layout.ab_arrays()
        tail_words = int(ab["payload"][ab["offset"]
                                       >= arena_layout.tail_start].sum())
        compact = int(r.touched.size) * ARENA_TILE * 4 + tail_words * 4
        partials = arena_layout.n_tiles * 4
        out["arena_bytes"] = int(a)
        out["padding_ratio"] = float(arena_layout.padding_ratio)
        out["staging_arena"] = int(compact + partials)
        out["arena"] = int(model + a + a + a + compact + partials
                           + compact + parity)
        out["arena_resident"] = int(a + a + a + compact + partials
                                    + compact + parity)
        out["arena_owned"] = int(out["arena_resident"] - a)
        out["arena_async"] = int(out["arena_resident"] + a)
        out["arena_sharded"] = int(out["arena_resident"])
        out["arena_sharded_xfer"] = int(a)
        out["arena_shards"] = 1
    return out
