"""Soak-run availability/goodput accounting (the port of
``repro.fabric.availability``).

A trace-driven soak (``run_with_trace`` / ``TrainLoopConfig.mtbf``) emits
per-event tier diagnostics into ``FTController.stats["events"]`` and — via
:meth:`CheckpointFabric.redundancy_state` — a per-step flag saying whether
every configured redundancy tier is fully placed on live hardware. This
module aggregates the two into the availability summary the ROADMAP asked
for: time-to-full-redundancy per event, the fraction of steps spent at
full redundancy (the window where the *next* failure is guaranteed cheap),
and how much recovery traffic stayed on the cheap tiers.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

# tiers that restore live values at ~zero perturbation vs the stale tiers
CHEAP_TIERS = ("PEER_REPLICA", "PARITY")
EXPENSIVE_TIERS = ("RUNNING_CKPT", "DISK")


def summarize_availability(events: Sequence[dict],
                           full_flags: Sequence[bool],
                           ) -> dict:
    """Aggregate per-event diagnostics + per-step redundancy flags.

    ``events``   — ``FTController.stats["events"]``-style dicts; entries
                   without a ``step`` (one-shot paper experiments) are
                   skipped for timing but still counted in tier totals.
    ``full_flags`` — ``full_flags[i]`` is the redundancy state *after*
                   step ``i + 1`` finished (events and maintenance
                   applied), as recorded by the soak loop.

    Returns::

        steps                 total steps observed
        n_events              recovery events
        frac_steps_full       goodput proxy: fraction of steps ending at
                              full redundancy
        time_to_full          per-event steps until full redundancy
                              returned (0 = same step, None = censored —
                              never restored within the run)
        mean_time_to_full     mean over restored events (None if none)
        censored_events       events never restored within the run
        lost_blocks           total blocks lost across events
        cheap_tier_blocks     blocks recovered from SURVIVOR-cost tiers
                              (replica/parity — live values, ~zero
                              perturbation)
        ckpt_disk_blocks      blocks that fell through to RUNNING_CKPT or
                              DISK (stale values — real perturbation)
    """
    flags = np.asarray(full_flags, bool)
    n_steps = int(flags.size)
    time_to_full: list[Optional[int]] = []
    lost = cheap = expensive = 0
    n_events = 0
    for ev in events:
        if ev.get("skipped"):
            continue
        n_events += 1
        counts = ev.get("tier_counts") or {}
        lost += int(ev.get("lost_blocks", 0))
        cheap += sum(int(counts.get(t, 0)) for t in CHEAP_TIERS)
        expensive += sum(int(counts.get(t, 0)) for t in EXPENSIVE_TIERS)
        step = ev.get("step")
        if step is None or not (1 <= int(step) <= n_steps):
            continue
        later = np.nonzero(flags[int(step) - 1:])[0]
        time_to_full.append(int(later[0]) if later.size else None)
    restored = [t for t in time_to_full if t is not None]
    return {
        "steps": n_steps,
        "n_events": n_events,
        "frac_steps_full": float(flags.mean()) if n_steps else 1.0,
        "time_to_full": time_to_full,
        "mean_time_to_full": (float(np.mean(restored)) if restored
                              else None),
        "censored_events": sum(1 for t in time_to_full if t is None),
        "lost_blocks": int(lost),
        "cheap_tier_blocks": int(cheap),
        "ckpt_disk_blocks": int(expensive),
    }
