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
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels.parity_xor.kernel import parity_xor_cuda
from repro_torch.kernels.parity_xor.ref import parity_xor_ref


@dataclasses.dataclass(eq=False)
class ParityPlan:
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
    t = plan.on(out.device)
    if out.device.type == "cpu":
        return parity_xor_ref(out, src, base, t)
    return parity_xor_cuda(out, src, base, t)
