"""Reed-Solomon RS(k, m) erasure codec and the integrity scrub's codec half.

The port of ``repro.fabric.rs``. :class:`RSCodec` generalizes
:class:`~repro_torch.fabric.parity.ParityCodec` from one XOR parity block
per group to ``m`` GF(256) parity rows over the same striping and the same
tile-aligned ``FrameLayout``, stored as the reference's ``(n_groups, m,
frame_elems)`` int32, so the two packages' rows compare byte for byte.
What the XOR tier lacks:

- **Multi-erasure recovery**: any <= m member losses of a group decode
  bit-exactly (Cauchy coefficients: every square submatrix inverts).
- **Silent-error detection**: the rows recomputed from the replica arena
  XOR the stored rows (the syndromes) are all zero unless a silent error
  corrupted the coded snapshot since encode.
- **Localization and correction** (m >= 2): row 0 is all ones, so for one
  corrupted member the row-0 syndrome is the error pattern and row ``r``
  is that pattern scaled by the member's coefficient; matching the
  scalings names the member, and XOR-ing the pattern back out corrects
  it. A single nonzero row names a corrupted stored row instead.

As in the XOR codec, nothing of size ``(total_blocks, frame_elems)`` or
``(n_groups, g, frame_elems)`` exists: encode, syndromes and decode are
gf256_mac launches over plans whose terms read the members' words where
they lie in the arena (``kernels/gf256_mac``). Syndromes are computed a
batch of groups at a time into one scratch buffer and reduced to nonzero
flags on the device; only the flagged groups' rows reach the host. A
correction and a bit-flip injection map frame columns to arena words
through the block's arena segments, not through a per-word index.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.arena import ArenaLayout, pack_arena
from repro_torch.core.blocks import BlockPartition
from repro_torch.fabric.parity import ParityCodec
from repro_torch.fabric.placement import ClusterView, rs_parity_homes
from repro_torch.kernels.gf256_mac.ops import (GFPlan, gf256_mac_plan,
                                               rs_decode_plan, rs_encode_plan)
from repro_torch.kernels.gf256_mac.tables import (gf_scale_words_np,
                                                  rs_coefficients,
                                                  rs_decode_weights)

# bytes of one batch of syndrome rows on the device
SYNDROME_BATCH_BYTES = 1 << 30


@dataclasses.dataclass
class Syndromes:
    """The nonzero syndromes of a scrub: ``rows[i]`` (m, frame_elems)
    int32 is group ``groups[i]``'s; every other group's are zero."""
    n_groups: int
    groups: np.ndarray     # (n,) int64, ascending
    rows: np.ndarray       # (n, m, frame_elems) int32

    def dense(self) -> np.ndarray:
        """The reference's ``(n_groups, m, frame_elems)`` form."""
        out = np.zeros((self.n_groups,) + self.rows.shape[1:], np.int32)
        out[self.groups] = self.rows
        return out


class RSCodec(ParityCodec):
    """RS(k, m) over GF(256) on the shared striping and frame layout.

    ``group_size`` is k (clamped to the alive hosts less m, as the XOR
    codec clamps it less 1; the tail group is not folded); ``n_parity`` is
    m. The arena sweep emits no RS rows, so the codec re-encodes from the
    sweep's snapshot arena every maintenance (``needs_arena_encode``).
    """

    needs_arena_encode = True
    supports_integrity = True

    def __init__(self, partition: BlockPartition, view: ClusterView,
                 group_size: int = 4, n_parity: int = 2,
                 arena_layout: Optional[ArenaLayout] = None):
        if n_parity < 1:
            raise ValueError("rs n_parity must be >= 1")
        self.n_parity = int(n_parity)
        super().__init__(partition, view, group_size, arena_layout)

    def _build(self) -> None:
        self._stripe()
        self.parity_homes = rs_parity_homes(self.members, self.view,
                                            self.n_parity)
        width = self.members.shape[1]
        self.coeff = rs_coefficients(width, self.n_parity)    # (m, width)
        # padding members carry coefficient 0 (dropped from the fold)
        self._coeff_rows = np.where(self.valid[None],
                                    self.coeff[:, None, :],
                                    0).astype(np.int32)  # (m, n_groups, g)
        self._plans: Optional[tuple] = None   # (layout, encode, syndromes)

    def gf_plans(self, arena_layout: ArenaLayout) -> tuple[GFPlan, GFPlan]:
        """The encode plan over ``arena_layout`` and its syndrome twin
        (seeded from the stored rows), built once per layout and
        striping."""
        if self._plans is None or self._plans[0] is not arena_layout:
            enc = rs_encode_plan(arena_layout, self.layout, self.members,
                                 self._coeff_rows)
            self._plans = (arena_layout, enc, enc.with_base())
        return self._plans[1], self._plans[2]

    @property
    def _shape(self) -> tuple[int, int, int]:
        return (self.n_groups, self.n_parity, self.layout.frame_elems)

    # -- encode ---------------------------------------------------------------

    def encode_arena(self, arena: torch.Tensor,
                     arena_layout: Optional[ArenaLayout] = None,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(n_groups, m, frame_elems) parity rows of a packed arena, in one
        gf256_mac launch on the card (each member word read once for all m
        rows). ``out``, when it has the shape and device, is overwritten."""
        plan, _ = self.gf_plans(arena_layout or self.arena_layout)
        if out is None or tuple(out.shape) != self._shape \
                or out.device != arena.device:
            out = torch.empty(self._shape, dtype=torch.int32,
                              device=arena.device)
        gf256_mac_plan(out.view(-1), arena, None, None, plan)
        return out

    def encode(self, step: int, values) -> None:
        """Re-encode every row from live values (a tree, packed first)."""
        self.encode_from_arena(step, pack_arena(values, self.arena_layout),
                               self.arena_layout)

    def encode_from_arena(self, step: int, arena: torch.Tensor,
                          arena_layout: ArenaLayout) -> None:
        """Encode from the sweep's snapshot arena, the buffer the replica
        tier stores, so ``refreshed_step == encoded_step`` holds and the
        arena recovery route and the scrub stay open. The previous rows'
        buffer is reused."""
        self.parity = self.encode_arena(arena, arena_layout, out=self.parity)
        self.encoded_step = int(step)

    # -- integrity ------------------------------------------------------------

    def syndromes_from_arena(self, arena: torch.Tensor,
                             arena_layout: ArenaLayout) -> Syndromes:
        """The nonzero syndromes of the coded state: the rows recomputed
        from ``arena`` XOR the stored rows, a batch of groups (at most
        ``SYNDROME_BATCH_BYTES`` of rows) per launch into one scratch
        buffer, each batch reduced to per-group nonzero flags on the
        device. Only the flagged groups' rows are copied to the host."""
        if self.parity is None:
            raise RuntimeError("no parity encoded yet")
        _, plan = self.gf_plans(arena_layout)
        per = self.n_parity * self.layout.frame_elems
        batch = max(1, min(self.n_groups, SYNDROME_BATCH_BYTES // (4 * per)))
        buf = torch.empty((batch * per,), dtype=torch.int32,
                          device=arena.device)
        stored = self.parity.view(-1)
        groups, rows = [], []
        for g0 in range(0, self.n_groups, batch):
            nb = min(batch, self.n_groups - g0)
            gf256_mac_plan(buf, arena, None, stored, plan, row0=g0,
                           n_rows=nb, out_shift=g0 * per)
            view = buf[:nb * per].view(nb, per)
            nz = torch.nonzero(view.ne(0).any(dim=1)).flatten()
            if nz.numel():
                groups.append(nz.cpu().numpy() + g0)
                rows.append(view[nz].cpu().numpy())
        shape = (-1, self.n_parity, self.layout.frame_elems)
        return Syndromes(
            n_groups=self.n_groups,
            groups=(np.concatenate(groups) if groups
                    else np.empty((0,), np.int64)).astype(np.int64),
            rows=(np.concatenate(rows) if rows
                  else np.empty((0, per), np.int32)).reshape(shape))

    def localize_corruption(self, syndromes: Syndromes) -> list[dict]:
        """Per-group corruption reports from :meth:`syndromes_from_arena`'s
        flagged groups: ``kind`` ("member" or "parity"), the guilty
        ``block``/``member`` slot or parity ``row`` when localized,
        ``localized``, and the error pattern ``delta`` (the row-0 syndrome)
        that :meth:`correct_in_arena` XORs back out. m = 1 detects only."""
        groups, rows = syndromes.groups, syndromes.rows
        reports: list[dict] = []
        for j, s in zip(groups.tolist(), rows):
            rows_nz = np.nonzero(s.any(axis=1))[0]
            if self.n_parity >= 2 and rows_nz.size == 1:
                # a member error perturbs every row (no coefficient is 0),
                # so a single nonzero row is the stored row itself gone bad
                r = int(rows_nz[0])
                reports.append(dict(group=int(j), kind="parity", row=r,
                                    member=-1, block=-1, localized=True,
                                    delta=s[r]))
                continue
            delta = s[0]  # row 0 is all ones: the raw error pattern
            cand = []
            if self.n_parity >= 2:
                for slot in np.nonzero(self.valid[j])[0]:
                    if all(np.array_equal(
                            gf_scale_words_np(delta,
                                              int(self.coeff[r, slot])),
                            s[r]) for r in range(1, self.n_parity)):
                        cand.append(int(slot))
            if len(cand) == 1:
                slot = cand[0]
                reports.append(dict(group=int(j), kind="member", row=-1,
                                    member=slot,
                                    block=int(self.members[j, slot]),
                                    localized=True, delta=delta))
            else:
                # no fingerprint or several match: detected, not localized
                reports.append(dict(group=int(j), kind="member", row=-1,
                                    member=-1, block=-1, localized=False,
                                    delta=delta))
        return reports

    def correct_in_arena(self, arena: torch.Tensor, report: dict,
                         arena_layout: Optional[ArenaLayout] = None
                         ) -> torch.Tensor:
        """Apply one localized correction in place: XOR the error pattern
        out of the replica arena (a member; the block's payload words) or
        out of the stored parity row (a parity row). Returns ``arena``."""
        delta = np.asarray(report["delta"], np.int32)
        if report["kind"] == "parity":
            if self.parity is None:
                raise RuntimeError("no parity to correct")
            j, r = report["group"], report["row"]
            self.parity[j, r] ^= torch.from_numpy(delta.copy()).to(
                self.parity.device)
            return arena
        if not (report["localized"] and report["block"] >= 0):
            raise ValueError("only a localized member report can be "
                             "corrected")
        cols, words = self.arena_words_of(report["block"], arena_layout)
        nz = delta[cols] != 0
        if nz.any():
            idx = torch.from_numpy(words[nz]).to(arena.device)
            arena[idx] ^= torch.from_numpy(delta[cols[nz]]).to(arena.device)
        return arena

    # -- recovery --------------------------------------------------------------

    def decode_plan(self, arena_layout: ArenaLayout, recover_mask: np.ndarray,
                    available_mask: np.ndarray) -> tuple[GFPlan, np.ndarray]:
        """The gf256_mac plan that decodes the blocks of ``recover_mask``
        (each group at most m erasures, the members ``available_mask``
        lacks) and the arena blocks its output covers, back to back."""
        recover = np.asarray(recover_mask, bool)
        available = np.asarray(available_mask, bool)
        width, m = self.members.shape[1], self.n_parity
        member_unavail = self.member_mask(~available)
        member_recover = self.member_mask(recover)
        # host-solved weights per targeted group: one (width + m) row per
        # erased ordinal, folding survivors and parity rows in one MAC
        weights = np.zeros((self.n_groups, m, width + m), np.int32)
        ordinal_of = np.full((self.n_groups, width), -1, np.int32)
        for j in np.nonzero(member_recover.any(axis=1))[0]:
            erased = np.nonzero(member_unavail[j])[0]
            if erased.size == 0 or erased.size > m:
                continue  # the planner never routes such a group here
            survivors = np.nonzero(self.valid[j] & ~member_unavail[j])[0]
            # prefer rows homed on devices alive in the view
            rows_alive = self.view.alive[self.parity_homes[j]]
            rows = np.concatenate([np.nonzero(rows_alive)[0],
                                   np.nonzero(~rows_alive)[0]])
            weights[j, :erased.size] = rs_decode_weights(
                self.coeff, erased, survivors, rows)
            ordinal_of[j, erased] = np.arange(erased.size)
        return rs_decode_plan(
            arena_layout, self.layout, m, self.group_of, self.members,
            np.nonzero(recover)[0], weights, ordinal_of,
            self.valid & ~member_unavail)

    def reconstruct_from_arena(self, arena: torch.Tensor,
                               arena_layout: ArenaLayout,
                               recover_mask: np.ndarray,
                               available_mask: np.ndarray):
        """Decode the blocks of ``recover_mask`` from the stored rows and
        the available members' words in ``arena`` (the encode-time
        snapshot): one gf256_mac launch whose rows are the lost arena
        segments (:meth:`decode_plan`). Returns ``(blocks, words)`` as the
        XOR codec does."""
        if self.parity is None:
            raise RuntimeError("no parity to reconstruct from")
        plan, blocks = self.decode_plan(arena_layout, recover_mask,
                                        available_mask)
        out = torch.empty((int(plan.row_len.astype(np.int64).sum()),),
                          dtype=torch.int32, device=arena.device)
        gf256_mac_plan(out, arena, self.parity.view(-1), None, plan)
        return blocks, out
