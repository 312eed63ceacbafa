"""Quickstart: SCAR fault tolerance on a classic model.

The port of ``examples/quickstart.py``. Trains multinomial logistic
regression (one of the paper's §5 workloads), takes prioritized partial
checkpoints through the arena-resident fault-tolerance path
(``FabricConfig()``: the live params feed the maintenance sweep and the
partial save as one flat arena), kills half the parameter blocks at
iteration 25, recovers partially, and reports the measured iteration cost
beside the Theorem 3.2 bound, the per-iteration maintenance overhead and
the telemetry run report.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart \\
          [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch

from repro_torch.core.iteration_cost import (estimate_contraction,
                                             single_perturbation_bound)
from repro_torch.core.policy import CheckpointPolicy
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.examples.common import mlr_model, parser, printer, run_draws
from repro_torch.fabric import FabricConfig
from repro_torch.telemetry import Recorder, format_report, run_report
from repro_torch.training.classic_runner import run_clean, run_with_failure

FAIL_ITER, MAX_ITERS = 25, 150


def run(device: DeviceLike = None, draws: Optional[dict] = None,
        verbose: bool = True) -> dict:
    """The quickstart on ``device`` (``cuda`` unless asked otherwise),
    fed ``draws`` where given (``examples.common``). Returns the clean
    run's κ, both runs' results, the fitted contraction, the bound and the
    telemetry report."""
    dev = resolve_device(device)
    log = printer(verbose)
    log("== SCAR quickstart: MLR + priority checkpoints + partial recovery")
    model = mlr_model(dev, draws)

    # 1. the unperturbed baseline (the κ(x, ε) reference)
    clean = run_clean(model, max_iters=MAX_ITERS, device=dev)["losses"]
    kappa_clean = int(np.argmax(np.asarray(clean) < model.eps))
    log(f"   clean run reaches eps in {kappa_clean} iterations")

    # 2. SCAR: prioritized 1/4-checkpoints at 4x frequency, partial
    # recovery, through the fabric (maintain and save over one flat arena)
    rec = Recorder()
    runs = run_draws(draws)
    res = run_with_failure(model, CheckpointPolicy.scar(fraction=0.25,
                                                        interval=32),
                           fail_iter=FAIL_ITER, fail_fraction=0.5,
                           max_iters=MAX_ITERS, clean_losses=clean,
                           fabric=FabricConfig(), recorder=rec,
                           draws=next(runs), device=dev)
    r = res["recovery"]
    tiers = {k: v for k, v in r["tier_counts"].items() if v}
    log(f"   failure at iter {FAIL_ITER} lost 50% of blocks; "
        f"checkpoint-only recovery would apply ||d'||^2="
        f"{r['partial_sq']:.2e} (full ||d||^2={r['full_sq']:.2e}); tiers "
        f"used: {tiers}, applied ||d||^2={r['applied_sq']:.2e}")
    log(f"   SCAR iteration cost: {res['iteration_cost']}")
    fs = res["fabric_stats"]
    log(f"   arena-native maintenance: {res['arena_state']}; overhead "
        f"{res['maint_seconds_per_iter'] * 1e3:.2f} ms/iter "
        f"({fs['maintain_bytes_moved'] // max(fs['parity_encodes'], 1) / 1e6:.2f}"
        f" MB/iter accounted incl. {fs['live_packs']} runner-side packs, "
        f"{fs['arena_maintains']} single-dispatch sweeps)")

    # 3. traditional full checkpoint-restore, the same failure
    trad = run_with_failure(model, CheckpointPolicy.traditional(32),
                            fail_iter=FAIL_ITER, fail_fraction=0.5,
                            max_iters=MAX_ITERS, clean_losses=clean,
                            draws=next(runs), device=dev)
    log(f"   traditional iteration cost: {trad['iteration_cost']}")

    # 4. the Theorem 3.2 bound for the SCAR perturbation
    c = estimate_contraction(np.sqrt(np.maximum(
        np.asarray(clean) - min(clean) * 0.98, 1e-9))[:100], burn_in=3)
    delta = float(np.sqrt(r["applied_sq"]))
    x0 = model.distance(model.init(torch.Generator().manual_seed(1)))
    bound = single_perturbation_bound(delta, c, T=FAIL_ITER, x0_err=x0)
    log(f"   Theorem 3.2 bound: {bound:.1f} iterations (c={c:.3f})")
    saved = trad["iteration_cost"] - res["iteration_cost"]
    log(f"== SCAR saved {saved} iterations vs traditional recovery")

    # 5. the same run through the telemetry layer: the ledger prices each
    # recovery with the bound above
    rec.ledger.set_rates(c, x0)
    report = run_report(rec, horizon=MAX_ITERS)
    log("\n== telemetry run report (SCAR run)")
    log(format_report(report))
    return {"clean_losses": clean, "kappa_clean": kappa_clean, "scar": res,
            "traditional": trad, "c": c, "x0_err": x0, "bound": bound,
            "saved": saved, "report": report}


def parse_args(argv: Optional[list] = None) -> argparse.Namespace:
    return parser(__doc__).parse_args(argv)


def main(argv: Optional[list] = None) -> dict:
    return run(parse_args(argv).device)


if __name__ == "__main__":
    main()
