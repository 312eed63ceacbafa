"""Experiment runner for the classic iterative-convergent models.

The port of ``repro.training.classic_runner`` without the fabric:

- ``run_clean``              -- unperturbed trajectory (the κ(x, ε) baseline).
- ``run_with_perturbation``  -- one synthetic perturbation at iteration T
                               (random / adversarial / reset): Figures 3/5/6.
- ``run_with_failure``       -- the SCAR lifecycle: periodic (partial)
                               checkpoints via FTController, a failure of a
                               fraction p of parameter blocks at iteration
                               ``fail_iter``, recovery (full or partial), then
                               on to convergence: Figures 7/8.

All return loss trajectories + the empirical iteration cost
ι = κ(y, ε) − κ(x, ε) measured as the paper does. The runners run on
``device`` (``cuda`` unless asked otherwise), which must be the model's.
``run_with_trace`` needs the fabric and is not ported yet.
"""
from __future__ import annotations

import copy
import time
from typing import Any, Optional

import torch

from repro_torch.core.blocks import partition_pytree
from repro_torch.core.controller import FTController
from repro_torch.core.iteration_cost import (empirical_iteration_cost,
                                             iterations_to_eps)
from repro_torch.core.perturb import (adversarial_perturbation,
                                      random_perturbation, reset_perturbation)
from repro_torch.core.policy import CheckpointPolicy
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.classic import IterativeModel, fold_in
from repro_torch.telemetry.recorder import NULL_RECORDER

PyTree = Any


def _run_device(model: IterativeModel, device: DeviceLike) -> torch.device:
    dev = resolve_device(device)
    if model.device != dev:
        raise ValueError(f"model {model.name} lives on {model.device}; the "
                         f"run asked for {dev}")
    return dev


def iterations_to_converge(model: IterativeModel, max_iters: int = 400,
                           seed: int = 0, device: DeviceLike = None) -> int:
    traj = run_clean(model, max_iters, seed, device=device)["losses"]
    return iterations_to_eps(traj, model.eps)


def run_clean(model: IterativeModel, max_iters: int, seed: int = 0,
              stop_at_eps: bool = False, device: DeviceLike = None) -> dict:
    _run_device(model, device)
    p = model.init(torch.Generator().manual_seed(1))
    losses = []
    for i in range(1, max_iters + 1):
        p = model.step(p, fold_in(seed, i), i)
        losses.append(float(model.loss(p)))
        if stop_at_eps and losses[-1] < model.eps:
            break
    return {"losses": losses, "params": p}


def run_with_perturbation(model: IterativeModel, *, kind: str,
                          at_iter: int, size: Optional[float] = None,
                          fraction: Optional[float] = None,
                          max_iters: int = 400, seed: int = 0,
                          clean_losses: Optional[list] = None,
                          device: DeviceLike = None) -> dict:
    """One perturbation at ``at_iter`` (types of §5.2), run to max_iters.

    kind: "random" (needs size), "adversarial" (needs size),
    "reset" (needs fraction -- reset random blocks to x^(0)).
    """
    _run_device(model, device)
    p0 = model.init(torch.Generator().manual_seed(1))
    partition = partition_pytree(p0, model.block_rows,
                                 colocate=model.colocate)
    p = p0
    losses = []
    delta_norm = 0.0
    for i in range(1, max_iters + 1):
        if i == at_iter:
            gen = fold_in(seed + 77, i)
            if kind == "random":
                p, dn = random_perturbation(gen, p, size)
            elif kind == "adversarial":
                p, dn = adversarial_perturbation(p, model.x_star(), size)
            elif kind == "reset":
                p, dn = reset_perturbation(gen, p, p0, fraction, partition)
            else:
                raise ValueError(kind)
            delta_norm = float(dn)
        p = model.step(p, fold_in(seed, i), i)
        losses.append(float(model.loss(p)))
    if clean_losses is None:
        clean_losses = run_clean(model, max_iters, seed,
                                 device=model.device)["losses"]
    cost = empirical_iteration_cost(losses, clean_losses, model.eps)
    return {"losses": losses, "delta_norm": delta_norm,
            "iteration_cost": cost,
            "kappa_perturbed": iterations_to_eps(losses, model.eps),
            "kappa_clean": iterations_to_eps(clean_losses, model.eps)}


def run_with_failure(model: IterativeModel, policy: CheckpointPolicy, *,
                     fail_iter: int, fail_fraction: float,
                     max_iters: int = 400, seed: int = 0,
                     clean_losses: Optional[list] = None,
                     store=None, fabric=None,
                     recorder=None, device: DeviceLike = None) -> dict:
    """The SCAR lifecycle on one classic model (Figures 7/8), fabric-less.

    The failure destroys ``fail_fraction`` of parameter blocks uniformly at
    random (the paper's model); recovery follows ``policy.recovery`` from
    the running checkpoint.
    """
    dev = _run_device(model, device)
    rec = recorder if recorder is not None else NULL_RECORDER
    p = model.init(torch.Generator().manual_seed(1))
    ctl = FTController(p, policy, norm_aux=model.norm_aux, store=store,
                       rng=torch.Generator().manual_seed(seed + 13),
                       colocate=model.colocate, fabric=fabric,
                       recorder=recorder, device=dev)
    losses = []
    recovery_info = {}
    maint_seconds = 0.0
    for i in range(1, max_iters + 1):
        p = model.step(p, fold_in(seed, i), i)
        t0 = time.perf_counter()
        ctl.maybe_checkpoint(i, p)
        maint_seconds += time.perf_counter() - t0
        if i == fail_iter:
            with rec.span("recovery", step=i):
                lost = ctl.sample_failure(fail_fraction)
                p, recovery_info = ctl.on_failure(p, lost, step=i)
        losses.append(float(model.loss(p)))
    if clean_losses is None:
        clean_losses = run_clean(model, max_iters, seed, device=dev)["losses"]
    cost = empirical_iteration_cost(losses, clean_losses, model.eps)
    return {"losses": losses, "iteration_cost": cost,
            "recovery": copy.deepcopy(recovery_info),
            "controller_stats": copy.deepcopy(ctl.stats),
            "fabric_stats": None,
            "arena_state": False,
            "maint_seconds_per_iter": maint_seconds / max_iters,
            "kappa_perturbed": iterations_to_eps(losses, model.eps),
            "kappa_clean": iterations_to_eps(clean_losses, model.eps)}
