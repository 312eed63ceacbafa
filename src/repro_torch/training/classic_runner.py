"""Experiment runner for the classic iterative-convergent models.

The port of ``repro.training.classic_runner``:

- ``run_clean``              -- unperturbed trajectory (the κ(x, ε) baseline).
- ``run_with_perturbation``  -- one synthetic perturbation at iteration T
                               (random / adversarial / reset): Figures 3/5/6.
- ``run_with_failure``       -- the SCAR lifecycle: periodic (partial)
                               checkpoints via FTController, a failure of a
                               fraction p of parameter blocks (or, with a
                               fabric, of one whole failure domain) at
                               iteration ``fail_iter``, recovery (full,
                               partial, or tiered through the fabric), then
                               on to convergence: Figures 7/8.
- ``run_with_trace``         -- degraded-mode soak: a multi-event failure
                               trace whose failed domains stay dead in the
                               fabric's cluster view; elastic fabrics
                               re-home and re-seed between events, and
                               domains optionally heal ``heal_after``
                               iterations later.

All return loss trajectories + the empirical iteration cost
ι = κ(y, ε) − κ(x, ε) measured as the paper does. The runners run on
``device`` (``cuda`` unless asked otherwise), which must be the model's.
"""
from __future__ import annotations

import copy
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.blocks import ReplayDraws, partition_pytree
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


def _fabric_step(ctl: FTController, i: int, p: PyTree,
                 use_arena: bool) -> None:
    """One iteration's fault-tolerance work: maintain before the save (the
    sweep's PRIORITY scores are measured against the pre-save checkpoint).
    On arena-capable controllers the live params are packed once, only on
    iterations that read them, and the pack becomes the replica itself
    (``own_live``), so the total cost equals the tree interface's."""
    packed = use_arena and ctl.live_value_needed(i)
    live = ctl.pack_live(p, account=True) if packed else p
    ctl.maintain(i, live, own_live=packed)
    ctl.maybe_checkpoint(i, live, own_live=packed)


def run_with_failure(model: IterativeModel, policy: CheckpointPolicy, *,
                     fail_iter: int, fail_fraction: float,
                     max_iters: int = 400, seed: int = 0,
                     clean_losses: Optional[list] = None,
                     store=None, fabric=None,
                     fail_domain: str = "uniform",
                     arena_state: bool = True,
                     recorder=None, draws: Optional[list] = None,
                     device: DeviceLike = None) -> dict:
    """The SCAR lifecycle on one classic model (Figures 7/8).

    The failure destroys ``fail_fraction`` of parameter blocks uniformly at
    random (the paper's model) or, with ``fabric`` and ``fail_domain`` one
    of ``"device"``/``"host"``/``"rack"``, one whole failure domain.
    Recovery follows ``policy.recovery`` from the running checkpoint, or
    the fabric's tier planner when a fabric is given. ``arena_state``
    (default): on an arena-capable controller every maintain and save
    takes the live params as one packed arena (bit-identical results to
    ``False``, the tree interface). ``store`` is the controller's disk
    mirror. ``draws`` (block-id arrays recorded elsewhere, e.g. the
    reference's as numpy) replace the controller's generator: the uniform
    failure and each RANDOM-strategy save take the next one
    (:class:`~repro_torch.core.blocks.ReplayDraws`).
    """
    if fail_domain != "uniform" and fabric is None:
        raise ValueError("correlated fail_domain needs a fabric")
    dev = _run_device(model, device)
    rec = recorder if recorder is not None else NULL_RECORDER
    p = model.init(torch.Generator().manual_seed(1))
    rng = (torch.Generator().manual_seed(seed + 13) if draws is None
           else ReplayDraws(draws, seed + 13))
    ctl = FTController(p, policy, norm_aux=model.norm_aux, store=store,
                       rng=rng, colocate=model.colocate, fabric=fabric,
                       recorder=recorder, device=dev)
    use_arena = arena_state and ctl.arena_ready
    losses = []
    recovery_info = {}
    maint_seconds = 0.0
    for i in range(1, max_iters + 1):
        p = model.step(p, fold_in(seed, i), i)
        t0 = time.perf_counter()
        _fabric_step(ctl, i, p, use_arena)
        if ctl.fabric is not None and not ctl.fabric.cfg.async_maintain:
            # book the sweep's device work, not just its launch; async
            # maintenance settles under the next iteration's model step
            # instead, and its last epoch after the loop
            ctl.fabric.block_until_maintained()
        maint_seconds += time.perf_counter() - t0
        if i == fail_iter:
            with rec.span("recovery", step=i, domain=fail_domain):
                if fail_domain == "uniform":
                    lost = ctl.sample_failure(fail_fraction)
                    p, recovery_info = ctl.on_failure(p, lost, step=i)
                else:
                    lost, failed = ctl.sample_domain_failure(fail_domain)
                    p, recovery_info = ctl.on_failure(
                        p, lost, failed_devices=failed, step=i)
        losses.append(float(model.loss(p)))
    if ctl.fabric is not None:
        # settle the last async epoch (a no-op in sync mode): its wait
        # belongs to the run
        t0 = time.perf_counter()
        ctl.fabric.block_until_maintained()
        maint_seconds += time.perf_counter() - t0
    if clean_losses is None:
        clean_losses = run_clean(model, max_iters, seed, device=dev)["losses"]
    cost = empirical_iteration_cost(losses, clean_losses, model.eps)
    # snapshots: the controller and fabric keep mutating their dicts
    return {"losses": losses, "iteration_cost": cost,
            "recovery": copy.deepcopy(recovery_info),
            "controller_stats": copy.deepcopy(ctl.stats),
            "fabric_stats": (copy.deepcopy(ctl.fabric.stats)
                             if ctl.fabric is not None else None),
            "arena_state": use_arena,
            "maint_seconds_per_iter": maint_seconds / max_iters,
            "kappa_perturbed": iterations_to_eps(losses, model.eps),
            "kappa_clean": iterations_to_eps(clean_losses, model.eps)}


def run_with_trace(model: IterativeModel, policy: CheckpointPolicy, *,
                   fabric, max_iters: int = 400, seed: int = 0,
                   mtbf: Optional[dict] = None, trace=None,
                   heal_after: Optional[int] = None,
                   clean_losses: Optional[list] = None,
                   store=None, arena_state: bool = True,
                   recorder=None, device: DeviceLike = None) -> dict:
    """Degraded-mode soak on one classic model: a multi-event failure trace
    (an explicit list of :class:`~repro_torch.fabric.FailureEvent`, or one
    sampled from ``mtbf``) recovered through the fabric's tier planner.

    Failed domains stay dead in the fabric's view between events. With
    ``FabricConfig(elastic=True)`` the placement engine re-homes, re-seeds
    and re-stripes after every event; without it later events fall through
    to the expensive tiers. Same-step events are one correlated loss.
    ``heal_after`` re-admits a failed domain that many iterations later.
    Returns the losses, the per-event diagnostics, the availability
    summary and the iteration cost.
    """
    if fabric is None:
        raise ValueError("run_with_trace needs a fabric")
    from repro_torch.fabric.availability import summarize_availability
    dev = _run_device(model, device)
    rec = recorder if recorder is not None else NULL_RECORDER
    p = model.init(torch.Generator().manual_seed(1))
    ctl = FTController(p, policy, norm_aux=model.norm_aux, store=store,
                       rng=torch.Generator().manual_seed(seed + 13),
                       colocate=model.colocate, fabric=fabric,
                       recorder=recorder, device=dev)
    if trace is None:
        if mtbf is None:
            raise ValueError("pass an explicit trace or mtbf means")
        trace = ctl.fabric.domains.sample_failure_trace(
            np.random.default_rng(seed + 5), max_iters, mtbf)
    events_at: dict[int, list] = {}
    for ev in trace:
        events_at.setdefault(max(1, min(ev.step, max_iters)), []).append(ev)
    use_arena = arena_state and ctl.arena_ready
    heal_at: dict[int, list] = {}
    events_out: list[dict] = []
    losses = []
    redundancy_full: list[bool] = []
    for i in range(1, max_iters + 1):
        p = model.step(p, fold_in(seed, i), i)
        _fabric_step(ctl, i, p, use_arena)
        evs = events_at.pop(i, [])
        if len(evs) > 1:
            names = ",".join(f"{e.kind}:{e.index}" for e in evs)
            with rec.span("recovery", step=i, domain=names):
                p, info = ctl.on_domain_events(
                    p, [(e.kind, e.index) for e in evs], step=i)
            info["step"] = i
            events_out.append(info)
            if heal_after is not None:
                applied = {(a["kind"], a["index"])
                           for a in info.get("events", [])}
                for ev in evs:
                    if (ev.kind, ev.index) in applied:
                        heal_at.setdefault(i + heal_after, []).append(ev)
        elif evs:
            ev = evs[0]
            with rec.span("recovery", step=i,
                          domain=f"{ev.kind}:{ev.index}"):
                p, info = ctl.on_domain_event(p, ev.kind, ev.index, step=i)
            info["step"] = i
            events_out.append(info)
            if heal_after is not None and not info.get("skipped"):
                heal_at.setdefault(i + heal_after, []).append(ev)
        for ev in heal_at.pop(i, []):
            with rec.span("heal", step=i, domain=f"{ev.kind}:{ev.index}"):
                ctl.heal_domain(ev.kind, ev.index, p, step=i)
        # placement health after this step's events and heals
        redundancy_full.append(ctl.fabric.redundancy_state()["full"])
        losses.append(float(model.loss(p)))
    # settle the last async epoch before the stats snapshot (a no-op in
    # sync mode)
    ctl.fabric.block_until_maintained()
    if clean_losses is None:
        clean_losses = run_clean(model, max_iters, seed, device=dev)["losses"]
    cost = empirical_iteration_cost(losses, clean_losses, model.eps)
    return {"losses": losses, "iteration_cost": cost,
            "events": copy.deepcopy(events_out),
            "controller_stats": copy.deepcopy(ctl.stats),
            "fabric_stats": copy.deepcopy(ctl.fabric.stats),
            "availability": summarize_availability(events_out,
                                                   redundancy_full),
            "kappa_perturbed": iterations_to_eps(losses, model.eps),
            "kappa_clean": iterations_to_eps(clean_losses, model.eps)}
