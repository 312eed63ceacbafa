"""Predictive checkpoint-policy advisor (the port of ``repro.core.advisor``:
host arithmetic, no kernel), the paper's §7 future work, implemented
("by approximating c and ‖x⁰−x*‖, we may obtain a predictive
model which can be evaluated on-the-fly to inform decisions made by a
system during run-time").

Model: expected run time per Daly (2006), with T_rework replaced by the
Theorem 3.2 iteration-cost bound applied to the *expected recovery
perturbation* of a (fraction r, interval C) policy:

    E‖δ‖ ≈ p_loss^{1/2} · drift(age)          (Thm 4.2: E‖δ′‖² = p‖δ‖²)
    age   ≈ staleness of the running checkpoint under (r, rC) saves
    ι(δ)  ≤ log(1 + c^{-T}·E‖δ‖ / ‖x⁰−x*‖) / log(1/c)

The advisor observes the live run (drift per iteration from the running
checkpoint, measured t_dump / t_iter, fitted c) and scores a grid of
candidate policies, returning the one minimizing expected time overhead:

    overhead(r, C) = t_dump(r)/interval(r,C)
                   + failure_rate · ι(r, C) · t_iter

This is deliberately a *planning* estimate — coarse, monotone in the right
arguments, cheap to evaluate every few hundred iterations.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.iteration_cost import estimate_contraction
from repro_torch.core.policy import (CheckpointPolicy, RecoveryMode,
                                     SelectionStrategy)


@dataclasses.dataclass
class RunObservations:
    """What the advisor needs from the live run."""
    drift_per_iter: float        # mean ‖x_k − x_{k−1}‖ (or per-block drift sum)
    x0_err: float                # ‖x⁰ − x*‖ estimate (e.g. loss-scaled)
    c: float                     # fitted contraction factor
    t_iter: float                # seconds per training iteration
    t_dump_full: float           # seconds to save a FULL checkpoint
    failure_rate: float          # failures per iteration (per-iter prob)
    loss_fraction: float = 0.5   # expected fraction of blocks lost
    current_iter: int = 100


def expected_iteration_cost(obs: RunObservations, r: float, C: int) -> float:
    """Thm 3.2 bound on the rework iterations for policy (r, C)."""
    interval = max(1, round(r * C))
    # staleness: a block saved every C iterations on average (priority
    # saving reduces the *effective* drift of the hottest blocks; we use
    # the conservative round-robin age C/2 + interval/2)
    age = C / 2.0 + interval / 2.0
    delta = math.sqrt(obs.loss_fraction) * obs.drift_per_iter * age
    if delta <= 0:
        return 0.0
    # the Thm 3.2 bound for a single perturbation at the current iterate
    T = obs.current_iter
    c = min(max(obs.c, 1e-6), 1 - 1e-6)
    ratio = (c ** (-min(T, 500))) * delta / max(obs.x0_err, 1e-12)
    ratio = min(ratio, 1e12)
    return math.log1p(ratio) / math.log(1.0 / c)


def expected_overhead(obs: RunObservations, r: float, C: int) -> float:
    """Expected seconds of overhead per iteration for policy (r, C)."""
    interval = max(1, round(r * C))
    dump = obs.t_dump_full * r / interval             # amortized save cost
    rework = obs.failure_rate * expected_iteration_cost(obs, r, C) * obs.t_iter
    return dump + rework


def advise(obs: RunObservations,
           r_grid: Sequence[float] = (1.0, 0.5, 0.25, 0.125, 0.0625),
           C_grid: Sequence[int] = (4, 8, 16, 32, 64),
           norm: str = "l2") -> tuple[CheckpointPolicy, dict]:
    """Pick the (r, C) minimizing expected overhead. Returns (policy, report)."""
    best, best_cost, table = None, float("inf"), {}
    for r in r_grid:
        for C in C_grid:
            cost = expected_overhead(obs, r, C)
            table[(r, C)] = cost
            if cost < best_cost:
                best, best_cost = (r, C), cost
    r, C = best
    policy = CheckpointPolicy(fraction=r, full_interval=C,
                              strategy=SelectionStrategy.PRIORITY,
                              recovery=RecoveryMode.PARTIAL, norm=norm)
    return policy, {"chosen": best, "expected_overhead_s": best_cost,
                    "table": {f"r={k[0]},C={k[1]}": v
                              for k, v in sorted(table.items())}}


def _poisson_tail(lam: float, m: int) -> float:
    """P[N > m] for N ~ Poisson(lam) (summed complement, stable for the
    small lam / small m regime the advisor lives in)."""
    if lam <= 0:
        return 0.0
    term, acc = math.exp(-lam), math.exp(-lam)
    for i in range(1, m + 1):
        term *= lam / i
        acc += term
    return max(0.0, 1.0 - acc)


def advise_code(mtbf: dict, *, window: int, model_bytes: int,
                budget_bytes: Optional[int] = None,
                n_hosts: int = 4,
                k_grid: Sequence[int] = (2, 3, 4, 6, 8),
                m_grid: Sequence[int] = (1, 2, 3),
                target_risk: float = 1e-4) -> tuple[tuple[int, int], dict]:
    """Pick an RS(k, m) code from an MTBF trace and a redundancy budget.

    Failure model: domain losses arrive independently per kind with the
    given MTBF means (steps), so the number landing inside one
    maintenance ``window`` (the steps between re-encodes — losses in the
    same window are *simultaneous* as far as the code is concerned) is
    Poisson with rate ``window·Σ 1/mtbf``. A code of strength m dies
    when a window sees > m losses; conservatively every loss is assumed
    to hit the same parity group (correlated placement — the worst case
    the striping cannot always avoid on small topologies).

    Feasibility: k + m host-disjoint placements must exist
    (``k + m ≤ n_hosts``), the GF(256) Cauchy construction needs
    ``k + m ≤ 256``, and the parity arena footprint ``model_bytes·m/k``
    must fit ``budget_bytes`` (None = unbounded). Among candidates whose
    window-loss risk meets ``target_risk``, the cheapest redundancy
    fraction m/k wins (widest k tie-breaks). If nothing inside the
    budget meets the risk target the advisor still returns the
    minimum-risk affordable code — flagged ``met_risk=False``, never
    silently."""
    lam = float(window) * sum(1.0 / float(v) for v in mtbf.values() if v)
    table = {}
    feasible, affordable = [], []
    for k in k_grid:
        for m in m_grid:
            if k + m > min(int(n_hosts), 256):
                continue
            bytes_ = model_bytes * m / k
            risk = _poisson_tail(lam, m)
            table[(k, m)] = {"risk": risk, "parity_bytes": bytes_}
            if budget_bytes is not None and bytes_ > budget_bytes:
                continue
            affordable.append((risk, m / k, -k, (k, m)))
            if risk <= target_risk:
                feasible.append((m / k, -k, risk, (k, m)))
    if not affordable:
        raise ValueError("no RS(k, m) candidate fits the topology/budget")
    if feasible:
        choice = min(feasible)[-1]
        met = True
    else:
        choice = min(affordable)[-1]
        met = False
    k, m = choice
    return choice, {"chosen": {"k": k, "m": m}, "met_risk": met,
                    "window_loss_rate": lam,
                    "risk": table[choice]["risk"],
                    "parity_bytes": table[choice]["parity_bytes"],
                    "table": {f"k={kk},m={mm}": v
                              for (kk, mm), v in sorted(table.items())}}


def observe_from_controller(controller, losses: Sequence[float],
                            t_iter: float,
                            failure_rate: float) -> RunObservations:
    """Build observations from a live FTController + loss history."""
    # crude ‖x⁰−x*‖ proxy: sqrt of initial loss gap scale
    losses = np.asarray(losses, dtype=np.float64)
    lo = float(losses.min())
    errs = np.sqrt(np.maximum(losses - lo * 0.98, 1e-12))
    c = estimate_contraction(errs[: max(len(errs) // 2, 2)], burn_in=1) \
        if len(errs) >= 4 else 0.95
    stats = controller.stats
    t_dump = stats["save_seconds"] / max(stats["saves"], 1)
    # drift per iter from the running checkpoint ages
    return RunObservations(
        drift_per_iter=float(errs[0] - errs[-1]) / max(len(errs), 1),
        x0_err=float(errs[0]),
        c=c,
        t_iter=t_iter,
        t_dump_full=t_dump / max(controller.policy.fraction, 1e-3),
        failure_rate=failure_rate,
        current_iter=len(losses),
    )
