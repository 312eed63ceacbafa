"""Perturbation-cost ledger: the paper's iteration-cost bound, per event.

The port of ``repro.telemetry.ledger``.

Every recovery event applies a perturbation ``δ′`` (zero when the lost
blocks came back from a fresh live tier, the running checkpoint's
staleness otherwise). The paper's Theorem 3.2 (and its SCAR refinement,
Thm 4.1) prices that perturbation in *iterations*:

    ι ≤ log(1 + c^{-T}·‖δ′‖ / ‖x⁰−x*‖) / log(1/c)

The ledger records, for every recovery, the lost blocks, the recovery
tiers used, the measured ‖δ′‖², and that bound — computed by calling
:func:`repro_torch.core.iteration_cost.single_perturbation_bound` (per event)
and :func:`repro_torch.core.iteration_cost.iteration_cost_bound` (jointly over
the whole fault history), so ledger numbers are bit-identical to the
theory module's. The running cumulative series is the run's
"iterations owed to faults" — the quantity behind the paper's headline
78–95% iteration-cost reduction, now a first-class observable.

The contraction rate ``c`` and initial distance ``‖x⁰−x*‖`` are usually
only known after a clean reference run; :meth:`set_rates` back-fills every
entry's bound, so the ledger can record online and price at the end.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Sequence

from repro_torch.core.iteration_cost import (iteration_cost_bound,
                                       single_perturbation_bound)


@dataclasses.dataclass
class LedgerEntry:
    step: Optional[int]            # iteration the failure hit (T)
    lost_blocks: int
    tier_counts: Optional[dict]    # blocks recovered per tier name
    applied_sq: float              # measured ‖δ′‖²
    delta_norm: float              # ‖δ′‖ = sqrt(applied_sq)
    bound: Optional[float] = None  # Thm-3.2/4.1 iteration-cost bound
    extra: dict = dataclasses.field(default_factory=dict)

    @property
    def source_tiers(self) -> dict:
        """Tiers that actually supplied blocks (nonzero counts only)."""
        return {k: v for k, v in (self.tier_counts or {}).items() if v}


class PerturbationLedger:
    """Append-only per-recovery cost accounting.

    ``c``/``x0_err`` may be passed up front (bounds computed as events
    arrive) or via :meth:`set_rates` afterwards (bounds back-filled).
    """

    def __init__(self, c: Optional[float] = None,
                 x0_err: Optional[float] = None) -> None:
        self.c = c
        self.x0_err = x0_err
        self.entries: list[LedgerEntry] = []

    # -- recording ----------------------------------------------------------

    def record(self, step: Optional[int], lost_blocks: int,
               tier_counts: Optional[dict], applied_sq: float,
               **extra: Any) -> LedgerEntry:
        applied_sq = float(applied_sq)
        entry = LedgerEntry(step=None if step is None else int(step),
                            lost_blocks=int(lost_blocks),
                            tier_counts=(dict(tier_counts)
                                         if tier_counts else None),
                            applied_sq=applied_sq,
                            delta_norm=math.sqrt(max(applied_sq, 0.0)),
                            extra=dict(extra))
        entry.bound = self._bound(entry)
        self.entries.append(entry)
        return entry

    def set_rates(self, c: float, x0_err: float) -> None:
        """Fix the contraction rate + initial distance and (re)price every
        recorded entry with them."""
        self.c = float(c)
        self.x0_err = float(x0_err)
        for e in self.entries:
            e.bound = self._bound(e)

    def _bound(self, e: LedgerEntry) -> Optional[float]:
        """Exactly ``single_perturbation_bound`` — never re-derived here."""
        if self.c is None or self.x0_err is None or e.step is None:
            return None
        return single_perturbation_bound(e.delta_norm, self.c,
                                         T=e.step, x0_err=self.x0_err)

    # -- series + aggregates ------------------------------------------------

    def iterations_owed(self) -> list[Optional[float]]:
        """Running cumulative sum of per-event bounds — the "iterations
        owed to faults" series (None while unpriced)."""
        out: list[Optional[float]] = []
        total = 0.0
        for e in self.entries:
            if e.bound is None:
                out.append(None)
            else:
                total += e.bound
                out.append(total)
        return out

    def delta_series(self, horizon: Optional[int] = None) -> Sequence[float]:
        """Dense ‖δ_ℓ‖ vector (length ``max(step)+1`` or ``horizon``) —
        the input shape Theorem 3.2's joint bound expects. Events at the
        same step accumulate (norms add as an upper bound)."""
        steps = [e.step for e in self.entries if e.step is not None]
        T = max(steps, default=0)
        n = (int(horizon) if horizon is not None else T) + 1
        dense = [0.0] * n
        for e in self.entries:
            if e.step is not None and e.step < n:
                dense[e.step] += e.delta_norm
        return dense

    def cumulative_bound(self, horizon: Optional[int] = None,
                         ) -> Optional[float]:
        """The joint Theorem-3.2 bound over the whole fault history —
        exactly ``iteration_cost_bound`` on the dense delta series."""
        if self.c is None or self.x0_err is None or not self.entries:
            return None
        return float(iteration_cost_bound(self.delta_series(horizon),
                                          self.c, self.x0_err))

    def summary(self) -> dict:
        """Ledger roll-up for reports: totals, the per-event table, and
        both cost aggregates (per-event sum + joint bound)."""
        owed = self.iterations_owed()
        priced = [b for b in owed if b is not None]
        per_tier: dict[str, int] = {}
        for e in self.entries:
            for t, n in (e.tier_counts or {}).items():
                per_tier[t] = per_tier.get(t, 0) + int(n)
        return {
            "n_events": len(self.entries),
            "lost_blocks": sum(e.lost_blocks for e in self.entries),
            "applied_sq_total": sum(e.applied_sq for e in self.entries),
            "tier_blocks": per_tier,
            "c": self.c,
            "x0_err": self.x0_err,
            "entries": [{
                "step": e.step, "lost_blocks": e.lost_blocks,
                "source_tiers": e.source_tiers,
                "applied_sq": e.applied_sq, "delta_norm": e.delta_norm,
                "bound": e.bound,
            } for e in self.entries],
            "iterations_owed": owed,
            "iterations_owed_total": (priced[-1] if priced else None),
            "cumulative_bound": self.cumulative_bound(),
        }
