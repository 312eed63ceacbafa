"""The paper's Figure 8 story on one model, end to end.

The port of ``examples/priority_vs_random_checkpoints.py``: priority,
round-robin and random partial-checkpoint strategies at matched write
budget, under the same failure (half the blocks at iteration 25), with the
rework iterations each costs (mean of 5 seeds) beside traditional full
checkpoints with full recovery.

Run:  PYTHONPATH=src python -m repro_torch.examples.priority_vs_random_checkpoints \\
          [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
from typing import Optional

import numpy as np

from repro_torch.core.policy import (CheckpointPolicy, RecoveryMode,
                                     SelectionStrategy)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.examples.common import mlr_model, parser, printer, run_draws
from repro_torch.training.classic_runner import run_clean, run_with_failure

FAIL_ITER, MAX_ITERS, SEEDS = 25, 150, 5


def run(device: DeviceLike = None, draws: Optional[dict] = None,
        seeds: int = SEEDS, verbose: bool = True) -> list:
    """Every strategy's rework iterations on ``device`` (``cuda`` unless
    asked otherwise), fed ``draws`` where given (``examples.common``).
    Returns ``[(strategy, r, [cost of each seed])]``, traditional first."""
    dev = resolve_device(device)
    log = printer(verbose)
    model = mlr_model(dev, draws)
    clean = run_clean(model, MAX_ITERS, device=dev)["losses"]
    runs = run_draws(draws)
    log(f"== Figure-8-style comparison on MLR (fail 50% of blocks @ iter "
        f"{FAIL_ITER})")
    log(f"{'strategy':12s} {'r':>6s} "
        f"{f'rework iters (mean of {seeds} seeds)':>32s}")

    def costs(policy):
        return [run_with_failure(model, policy, fail_iter=FAIL_ITER,
                                 fail_fraction=0.5, max_iters=MAX_ITERS,
                                 seed=s, clean_losses=clean,
                                 draws=next(runs), device=dev)
                ["iteration_cost"] for s in range(seeds)]

    rows = []
    trad = CheckpointPolicy(fraction=1.0, full_interval=8,
                            strategy=SelectionStrategy.ROUND_ROBIN,
                            recovery=RecoveryMode.FULL,
                            block_rows=model.block_rows)
    rows.append(("traditional", 1, costs(trad)))
    log(f"{'traditional':12s} {'1':>6s} {np.mean(rows[-1][2]):>32.1f}")
    for strat in (SelectionStrategy.PRIORITY, SelectionStrategy.ROUND_ROBIN,
                  SelectionStrategy.RANDOM):
        for r in (0.25, 0.125):
            pol = CheckpointPolicy(fraction=r, full_interval=8,
                                   strategy=strat,
                                   recovery=RecoveryMode.PARTIAL,
                                   block_rows=model.block_rows)
            rows.append((strat.value, r, costs(pol)))
            log(f"{strat.value:12s} {r:>6} {np.mean(rows[-1][2]):>32.1f}")
    return rows


def parse_args(argv: Optional[list] = None) -> argparse.Namespace:
    return parser(__doc__).parse_args(argv)


def main(argv: Optional[list] = None) -> list:
    return run(parse_args(argv).device)


if __name__ == "__main__":
    main()
