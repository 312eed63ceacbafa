"""Beyond the paper: its §7 predictive model as an adaptive checkpoint
advisor.

The port of ``examples/adaptive_checkpoint_policy.py``. Observes an
unperturbed MLR run, fits its contraction rate and drift, and lets the
advisor pick the (r, C) policy of least expected overhead under three
failure rates.

Run:  PYTHONPATH=src python -m repro_torch.examples.adaptive_checkpoint_policy \\
          [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
from typing import Optional

import numpy as np

from repro_torch.core.advisor import RunObservations, advise
from repro_torch.core.iteration_cost import estimate_contraction
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.examples.common import mlr_model, parser, printer
from repro_torch.training.classic_runner import run_clean

FAIL_RATES = (1e-5, 1e-3, 5e-2)


def run(device: DeviceLike = None, draws: Optional[dict] = None,
        verbose: bool = True) -> dict:
    """The observed run and the advice on ``device`` (``cuda`` unless
    asked otherwise), fed ``draws`` where given (``examples.common``).
    Returns the fitted ``c``, ``x0_err``, ``drift_per_iter`` and
    ``advice``: ``[(failure rate, r, C, partial interval, expected
    overhead s)]``."""
    dev = resolve_device(device)
    log = printer(verbose)
    model = mlr_model(dev, draws)
    log("== observing an unperturbed run of MLR...")
    losses = np.asarray(run_clean(model, 80, device=dev)["losses"])
    errs = np.sqrt(np.maximum(losses - losses.min() * 0.98, 1e-9))
    c = estimate_contraction(errs[:60], burn_in=3)
    log(f"   fitted contraction c = {c:.4f}; ||x0-x*|| ~ {errs[0]:.2f}")
    drift = float((errs[0] - errs[-1]) / len(errs))
    advice = []
    for fail_rate in FAIL_RATES:
        obs = RunObservations(
            drift_per_iter=drift, x0_err=float(errs[0]), c=c,
            t_iter=0.05, t_dump_full=0.02,
            failure_rate=fail_rate, loss_fraction=0.5, current_iter=60)
        policy, report = advise(obs)
        advice.append((fail_rate, policy.fraction, policy.full_interval,
                       policy.partial_interval,
                       report["expected_overhead_s"]))
        log(f"   failure_rate={fail_rate:8.0e} -> advise r={policy.fraction}"
            f" C={policy.full_interval}"
            f" (partial ckpt every {policy.partial_interval} iters,"
            f" expected overhead {report['expected_overhead_s'] * 1e3:.2f}"
            f" ms/iter)")
    log("== higher failure rates push toward smaller, more frequent,"
        " prioritized checkpoints: the paper's section 4.2 design, chosen"
        " automatically.")
    return {"c": c, "x0_err": float(errs[0]), "drift_per_iter": drift,
            "advice": advice}


def parse_args(argv: Optional[list] = None) -> argparse.Namespace:
    return parser(__doc__).parse_args(argv)


def main(argv: Optional[list] = None) -> dict:
    return run(parse_args(argv).device)


if __name__ == "__main__":
    main()
