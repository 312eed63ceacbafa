"""GF(256) multiply-accumulate: the dense form, RS encode/decode, and the
plan form the RS codec runs on the flat arena.

The reference composes its RS tier from one primitive on dense frames
(``ops.py:26,44,60``): ``gf256_mac`` over ``(n_groups, g, E)`` frames,
``rs_encode`` (one MAC per parity row) and ``rs_decode`` (a MAC over
member and parity frames with host-solved weights). Those three are here
with the same shapes. The codec itself never builds frames: it runs a
:class:`GFPlan`, parity_xor's rows and ``(column, offset, length)`` terms
(:class:`~repro_torch.kernels.parity_xor.ops.ParityPlan`) with ``m``
outputs per row and one coefficient byte per term and output, each term
reading the arena or the stored parity rows in place:

- :func:`rs_encode_plan`: one row per group, m outputs (its parity rows),
  a term per member segment; the output is the ``(n_groups, m, E)``
  parity. With the stored parity as the base (:meth:`GFPlan.with_base`)
  the same launch yields the scrub's syndromes.
- :func:`rs_decode_plan`: one row per arena segment of each block to
  recover, terms over the surviving members' segments and the group's
  parity rows, weighted by :func:`~.tables.rs_decode_weights`.

:func:`gf256_mac_plan` runs the kernel on CUDA tensors and the plain
version on CPU tensors; so do the dense functions.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels.gf256_mac.kernel import gf256_mac_cuda
from repro_torch.kernels.gf256_mac.ref import (gf256_mac_plan_ref,
                                               gf256_mac_ref)
from repro_torch.kernels.parity_xor.ops import (Pieces, PiecedPlan,
                                                _segments)

_ARRAYS = ("row_out", "row_len", "row_base", "term_ptr", "term_dst",
           "term_src", "term_len", "term_sel", "term_coef")
# the kernel's integer operations per (source word, output) of a term
# whose coefficient is 1, and above 1 (csrc/gf256_mac.cu's bound note)
XOR_OPS, MUL_OPS = 1, 14


@dataclasses.dataclass(eq=False)
class GFPlan(PiecedPlan):
    """Rows and terms of one gf256_mac launch (numpy). Row ``r`` has ``m``
    outputs: output ``q`` writes ``row_len[r]`` words at ``row_out[r] + q *
    out_stride``, seeded from ``base[row_base[r] + q * base_stride:]``
    (zeros where ``row_base[r]`` is -1). Term ``k`` of the row
    (``term_ptr[r] .. term_ptr[r + 1]``) folds ``gf_mul(term_coef[k * m +
    q], w)`` into output ``q`` for the words ``w`` of ``src`` (``term_sel``
    0) or ``src2`` (1) at ``[term_src[k], term_src[k] + term_len[k])``,
    landing at the row's words ``[term_dst[k], term_dst[k] +
    term_len[k])``."""
    m: int
    out_stride: int
    base_stride: int
    row_out: np.ndarray    # int64
    row_len: np.ndarray    # int32
    row_base: np.ndarray   # int64
    term_ptr: np.ndarray   # int64
    term_dst: np.ndarray   # int32
    term_src: np.ndarray   # int64
    term_len: np.ndarray   # int32
    term_sel: np.ndarray   # int8
    term_coef: np.ndarray  # uint8, (n_terms * m,)

    def __post_init__(self):
        super().__post_init__()
        self._on: dict[str, dict] = {}

    @property
    def n_rows(self) -> int:
        return int(self.row_len.size)

    def with_base(self) -> "GFPlan":
        """The same plan seeded from a buffer laid out like its output (the
        stored parity, for syndromes)."""
        return dataclasses.replace(self, row_base=self.row_out.copy(),
                                   base_stride=self.out_stride)

    def on(self, device: torch.device) -> dict:
        """The tables as tensors on ``device`` (uploaded once), plus the
        ints ``m``, ``out_stride`` and ``base_stride``."""
        key = str(device)
        t = self._on.get(key)
        if t is None:
            t = {k: torch.from_numpy(np.ascontiguousarray(getattr(self, k)))
                 .to(device) for k in _ARRAYS}
            t.update(m=self.m, out_stride=self.out_stride,
                     base_stride=self.base_stride)
            self._on[key] = t
        return t

    def _piece_extras(self, pc: Pieces, device) -> dict:
        """A piece entry's selector and coefficient bytes, ``pc_sel`` and
        ``pc_coef`` (``m`` per entry)."""
        coef = self.term_coef.reshape(-1, self.m)[pc.term].reshape(-1)
        return dict(pc_sel=torch.from_numpy(self.term_sel[pc.term]).to(device),
                    pc_coef=torch.from_numpy(coef).to(device))

    def limits(self, row0: int = 0, n_rows=None) -> dict:
        """Extents of rows ``[row0, row0 + n_rows)``: the output words
        ``[out_lo, out_hi)`` they write, and the words of ``src``, ``src2``
        and ``base`` they read."""
        n_rows = self.n_rows - row0 if n_rows is None else n_rows
        s = slice(row0, row0 + n_rows)
        ln = self.row_len[s].astype(np.int64)
        span = (self.m - 1) * self.out_stride
        out = {"out_lo": int(self.row_out[s].min()) if ln.size else 0,
               "out_hi": int((self.row_out[s] + span + ln).max())
               if ln.size else 0}
        rb = self.row_base[s]
        has = rb >= 0
        out["base_words"] = int((rb + (self.m - 1) * self.base_stride
                                 + ln)[has].max()) if has.any() else 0
        k = slice(int(self.term_ptr[row0]), int(self.term_ptr[row0 + n_rows]))
        end = self.term_src[k] + self.term_len[k]
        sel = self.term_sel[k]
        for name, v in (("src_words", 0), ("src2_words", 1)):
            out[name] = int(end[sel == v].max()) if (sel == v).any() else 0
        return out

    def read_bytes(self) -> int:
        """Bytes the whole launch must read: every term's source words and
        every based row's base words."""
        based = self.row_len[self.row_base >= 0].astype(np.int64).sum()
        return 4 * (int(self.term_len.astype(np.int64).sum())
                    + self.m * int(based))

    def write_bytes(self) -> int:
        return 4 * self.m * int(self.row_len.astype(np.int64).sum())

    def int_ops(self) -> int:
        """The kernel's 32-bit integer operations for the whole launch (its
        count, ``csrc/gf256_mac.cu``): per source word of a term and per
        output, ``XOR_OPS`` where the coefficient is 1 and ``MUL_OPS``
        (the split-table multiply) where it is above 1."""
        coef = self.term_coef.reshape(-1, self.m).astype(np.int64)
        per_word = (XOR_OPS * (coef == 1) + MUL_OPS * (coef > 1)).sum(axis=1)
        return int((self.term_len.astype(np.int64) * per_word).sum())


def _plan(m: int, out_stride: int, base_stride: int, rows: list,
          terms: list) -> GFPlan:
    """rows: (out, len, base) per row; terms: per row, a list of (dst,
    src, len, sel, coef bytes (m,))."""
    counts = np.asarray([len(ts) for ts in terms], np.int64)
    flat = [t for ts in terms for t in ts]
    rr = np.asarray(rows, np.int64).reshape(-1, 3)
    tt = np.asarray([t[:4] for t in flat], np.int64).reshape(-1, 4)
    coef = np.asarray([t[4] for t in flat], np.uint8).reshape(-1)
    return GFPlan(m=m, out_stride=int(out_stride),
                  base_stride=int(base_stride), row_out=rr[:, 0],
                  row_len=rr[:, 1].astype(np.int32), row_base=rr[:, 2],
                  term_ptr=np.concatenate([[0], np.cumsum(counts)]),
                  term_dst=tt[:, 0].astype(np.int32), term_src=tt[:, 1],
                  term_len=tt[:, 2].astype(np.int32),
                  term_sel=tt[:, 3].astype(np.int8), term_coef=coef)


def gf256_mac_plan(out: torch.Tensor, src: torch.Tensor, src2, base,
                   plan: GFPlan, row0: int = 0, n_rows=None,
                   out_shift: int = 0) -> torch.Tensor:
    """Run rows ``[row0, row0 + n_rows)`` of ``plan`` into ``out``: the plain
    version for CPU tensors, the kernel otherwise. Returns ``out``."""
    if out.device.type == "cpu":
        n = plan.n_rows - row0 if n_rows is None else n_rows
        return gf256_mac_plan_ref(out, src, src2, base, plan.on(out.device),
                                  row0, n, out_shift)
    return gf256_mac_cuda(out, src, src2, base, plan, row0, n_rows,
                          out_shift)


# ---------------------------------------------------------------------------
# The reference's dense form
# ---------------------------------------------------------------------------

def _dense_plan(n: int, g: int, e: int, coef: np.ndarray,
                based: bool) -> GFPlan:
    """Rows j of ``(n, g, e)`` frames folded into ``m = coef.shape[2]``
    outputs of ``e`` words each, output ``q`` of row ``j`` at ``(j * m +
    q) * e``; the base laid out like the output."""
    m = coef.shape[2]
    rows = [(j * m * e, e, j * m * e if based else -1) for j in range(n)]
    terms = [[(0, (j * g + i) * e, e, 0, coef[j, i]) for i in range(g)]
             for j in range(n)]
    return _plan(m, e, e, rows, terms)


def gf256_mac(frames: torch.Tensor, base: torch.Tensor,
              coeff) -> torch.Tensor:
    """``out[j] = base[j] ^ XOR_i gf_mul(coeff[j, i], frames[j, i])``.

    frames: (n_groups, g, E) int32; base: (n_groups, E) int32; coeff:
    (n_groups, g) GF(256) bytes (0 drops a member, 1 is XOR)."""
    if frames.device.type == "cpu":
        return gf256_mac_ref(frames, base, torch.as_tensor(coeff))
    n, g, e = frames.shape
    coef = np.asarray(torch.as_tensor(coeff).cpu(), np.int64)
    plan = _dense_plan(n, g, e, coef[:, :, None], based=True)
    out = torch.empty((n * e,), dtype=torch.int32, device=frames.device)
    gf256_mac_cuda(out, frames.to(torch.int32).reshape(-1).contiguous(),
                   None, base.to(torch.int32).reshape(-1).contiguous(), plan)
    return out.view(n, e)


def rs_encode(frames: torch.Tensor, coeff_rows) -> torch.Tensor:
    """Every parity row of every group: (n_groups, m, E) int32.

    frames: (n_groups, g, E) int32; coeff_rows: (m, n_groups, g) bytes,
    padding members zeroed. On the card all m rows come from one read of
    the frames."""
    coeff_rows = torch.as_tensor(coeff_rows)
    if frames.device.type == "cpu":
        base = torch.zeros((frames.shape[0], frames.shape[2]),
                           dtype=torch.int32)
        return torch.stack([gf256_mac_ref(frames, base, coeff_rows[r])
                            for r in range(coeff_rows.shape[0])], dim=1)
    n, g, e = frames.shape
    coef = np.asarray(coeff_rows.cpu(), np.int64).transpose(1, 2, 0)
    plan = _dense_plan(n, g, e, coef, based=False)
    out = torch.empty((n * coef.shape[2] * e,), dtype=torch.int32,
                      device=frames.device)
    gf256_mac_cuda(out, frames.to(torch.int32).reshape(-1).contiguous(),
                   None, None, plan)
    return out.view(n, coef.shape[2], e)


def rs_decode(frames_ext: torch.Tensor, weights) -> torch.Tensor:
    """One erased ordinal across every group: (n_groups, E) int32.

    frames_ext: (n_groups, g + m, E) member frames then parity rows;
    weights: (n_groups, g + m) host-solved decode coefficients."""
    base = torch.zeros((frames_ext.shape[0], frames_ext.shape[2]),
                       dtype=torch.int32, device=frames_ext.device)
    return gf256_mac(frames_ext, base, weights)


# ---------------------------------------------------------------------------
# Plans of the RS codec over the flat arena
# ---------------------------------------------------------------------------

def rs_encode_plan(arena_layout, frame_layout, members: np.ndarray,
                   coeff_rows: np.ndarray) -> GFPlan:
    """Group ``j``'s m parity rows (row ``j`` of the ``(n_groups, m,
    frame_elems)`` output) from its valid members' arena segments, member
    slot ``s`` weighted by ``coeff_rows[:, j, s]``."""
    fe = frame_layout.frame_elems
    m = int(coeff_rows.shape[0])
    segs = _segments(arena_layout, frame_layout,
                     range(arena_layout.partition.total_blocks))
    rows, terms = [], []
    for j, row in enumerate(np.asarray(members)):
        rows.append((j * m * fe, fe, -1))
        ts = []
        for s, b in enumerate(row):
            if b >= 0:
                c = coeff_rows[:, j, s]
                ts += [(col, off, n, 0, c) for col, off, n in segs[int(b)]]
        terms.append(ts)
    return _plan(m, fe, fe, rows, terms)


def rs_decode_plan(arena_layout, frame_layout, n_parity: int,
                   group_of: np.ndarray, members: np.ndarray,
                   recover: np.ndarray, weights: np.ndarray,
                   ordinal_of: np.ndarray, survivors: np.ndarray):
    """The plan that rebuilds the arena segments of the gids ``recover``:
    segment ``s`` of gid ``b``, erased ordinal ``q`` of group ``j``, is
    ``XOR_i gf_mul(W[i], member_i) XOR_r gf_mul(W[width + r], parity_r)``
    at the segment's columns, ``W = weights[j, q]``, members ``i`` over
    ``survivors[j]`` read from the arena (``src``) and parity rows from the
    stored ``(n_groups, m, frame_elems)`` parity (``src2``). A gid without
    an ordinal gets zeros. Returns ``(plan, blocks)``: the plan's output is
    the payload words of the arena blocks ``blocks``, back to back."""
    fe = frame_layout.frame_elems
    m = int(n_parity)
    width = members.shape[1]
    rows, terms, blocks = [], [], []
    out = 0
    for b in np.asarray(recover, np.int64):
        j = int(group_of[b])
        slot = int(np.nonzero(members[j] == b)[0][0])
        q = int(ordinal_of[j, slot])
        w = weights[j, q] if q >= 0 else np.zeros((width + m,), np.int64)
        kept = [(_segments(arena_layout, frame_layout,
                           [int(members[j, i])])[0], int(w[i]))
                for i in range(width) if survivors[j, i] and w[i]]
        for a in arena_layout.gid_ab[arena_layout.gid_ptr[b]:
                                     arena_layout.gid_ptr[b + 1]]:
            ab = arena_layout.blocks[a]
            col = frame_layout.cols[ab.leaf]
            rows.append((out, ab.payload, -1))
            ts = []
            for segs, c in kept:
                for cc, off, n in segs:
                    lo, hi = max(col, cc), min(col + ab.payload, cc + n)
                    if lo < hi:
                        ts.append((lo - col, off + lo - cc, hi - lo, 0, (c,)))
            for r in range(m):
                c = int(w[width + r])
                if c:
                    ts.append((0, (j * m + r) * fe + col, ab.payload, 1,
                               (c,)))
            terms.append(ts)
            blocks.append(int(a))
            out += ab.payload
    return _plan(1, 0, 0, rows, terms), np.asarray(blocks, np.int64)
