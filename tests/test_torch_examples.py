"""The ported classic examples (``python -m repro_torch.examples.<name>``:
quickstart, priority_vs_random_checkpoints, adaptive_checkpoint_policy,
correlated_failures) against the reference's scripts
(``examples/<name>.py``), on the CPU at their own sizes (the reference's
scripts take no size flags). ``serve_with_recovery`` is held in
``test_torch_example_serve.py``, ``train_lm_with_failures`` in
``test_torch_example_lm.py``.

Each reference script's ``main()`` runs in this process and its printed
results are parsed; the port's ``run`` is handed the reference's draws as
numpy (``examples.common``): the MLR batch indices of every (seed,
iteration) the script runs (``jax.random.choice`` on the runner's keys),
the model's ``eps`` and ``x_star``, and the block ids each reference
controller drew from its key while the script ran (its uniform failure and
its RANDOM-strategy saves), replayed by the port's controller in order
(``core.blocks.ReplayDraws``). Host and domain failures come from numpy
generators in both packages and are not carried. Held:

- iteration costs, κ, tier counts, fallbacks, lost blocks and the
  advisor's (r, C) choices exactly;
- losses within rtol 1e-4 (the two frameworks order their matmuls
  differently);
- numbers the reference prints rounded (‖δ′‖², the bound, c, expected
  overheads) to the printed precision: the port's value formatted as the
  reference formats it is the printed string.
"""
import ast
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import classic as jclassic
from repro.training import classic_runner as jrunner
from repro_torch.examples import (adaptive_checkpoint_policy, common,
                                  correlated_failures,
                                  priority_vs_random_checkpoints, quickstart)
from repro_torch.models.classic import fold_in
from repro_torch.telemetry import format_report

from reference_examples import find, reference_output


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while these tests run: the suite runs several
    workers on a few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mlr_ref():
    return jclassic.make_model("mlr", **common.MLR)


def _draws(ref, seeds, iters, runs=None):
    """The reference's draws as numpy: MLR batch indices for every (seed,
    iteration), ``eps``, ``x_star`` and, where given, the block ids each
    run's controller drew (``runs``)."""
    n, b = common.MLR["n"], common.MLR["batch"]
    its = jnp.arange(1, iters + 1)
    batches = {}
    for s in seeds:
        base = jax.random.PRNGKey(s)
        idx = np.asarray(jax.vmap(lambda i: jax.random.choice(
            jax.random.fold_in(base, i), n, (b,), replace=False))(its))
        batches.update({(s, int(i)): idx[k] for k, i in enumerate(its)})
    out = {"batches": batches, "eps": ref.eps,
           "x_star": jax.tree_util.tree_map(np.asarray, ref.x_star())}
    if runs is not None:
        out["blocks"] = runs
    return out


def test_draws_replay_the_reference_step(mlr_ref):
    """The carried batch draws are the reference step's: one step of each
    package from the same params agrees."""
    d = _draws(mlr_ref, [3], 2)
    key = jax.random.fold_in(jax.random.PRNGKey(3), 2)
    idx = np.asarray(jax.random.choice(key, common.MLR["n"],
                                       (common.MLR["batch"],), replace=False))
    assert np.array_equal(d["batches"][(3, 2)], idx)
    model = common.mlr_model("cpu", d)
    assert model.eps == mlr_ref.eps
    p = model.init(torch.Generator().manual_seed(1))
    got = model.step(p, fold_in(3, 2), 2)
    want = mlr_ref.step(mlr_ref.init(jax.random.PRNGKey(1)), key, 2)
    np.testing.assert_allclose(got["w"].numpy(), np.asarray(want["w"]),
                               rtol=1e-5, atol=1e-7)


def test_quickstart_against_reference(mlr_ref):
    text, runs = reference_output("quickstart")
    assert len(runs) == 2 and all(len(r) == 1 for r in runs)
    got = quickstart.run("cpu", _draws(mlr_ref, [0], 150, runs),
                         verbose=False)
    scar, trad = got["scar"], got["traditional"]
    assert got["kappa_clean"] == int(find(r"reaches ε in (\d+)", text)[0])
    tiers = ast.literal_eval(find(r"tiers used: (\{[^}]*\})", text)[0])
    assert {k: v for k, v in scar["recovery"]["tier_counts"].items()
            if v} == tiers
    partial, full = find(r"would apply \|\|δ'\|\|²=(\S+) \(full "
                          r"\|\|δ\|\|²=(\S+)\)", text)
    assert f"{scar['recovery']['partial_sq']:.2e}" == partial
    assert f"{scar['recovery']['full_sq']:.2e}" == full
    assert scar["recovery"]["applied_sq"] == 0.0
    assert scar["iteration_cost"] == int(
        find(r"SCAR iteration cost: (-?\d+)", text)[0])
    assert trad["iteration_cost"] == int(
        find(r"traditional iteration cost: (-?\d+)", text)[0])
    bound, c = find(r"bound: (\S+) iterations \(c=(\S+)\)", text)
    assert f"{got['bound']:.1f}" == bound and f"{got['c']:.3f}" == c
    assert got["saved"] == int(find(r"SCAR saved (-?\d+)", text)[0])
    fs = scar["fabric_stats"]
    assert f"{fs['live_packs']} runner-side packs, {fs['arena_maintains']} " \
           f"single-dispatch sweeps" in text
    # the telemetry report's event line, word for word
    events = find(r"(telemetry: \d+ events \([^)]*\))", text)[0]
    assert events in format_report(got["report"])
    # the losses, port against the reference's runner on the same draws
    want = jrunner.run_clean(mlr_ref, 150)["losses"]
    np.testing.assert_allclose(got["clean_losses"], want, rtol=1e-4)


def test_priority_vs_random_against_reference(mlr_ref):
    text, runs = reference_output("priority_vs_random_checkpoints")
    seeds = range(priority_vs_random_checkpoints.SEEDS)
    assert len(runs) == 7 * len(seeds)
    rows = priority_vs_random_checkpoints.run(
        "cpu", _draws(mlr_ref, seeds, 150, runs), verbose=False)
    want = re.findall(r"^(\w+)\s+([\d.]+)\s+(-?[\d.]+)$", text, re.M)
    assert len(want) == len(rows) == 7
    for (name, r, costs), (wname, wr, wmean) in zip(rows, want):
        assert (name, str(r)) == (wname, wr)
        # the mean of 5 integer costs, printed to one decimal: exact
        assert f"{np.mean(costs):.1f}" == wmean, (name, r, costs)


def test_adaptive_policy_against_reference(mlr_ref):
    text, _ = reference_output("adaptive_checkpoint_policy")
    got = adaptive_checkpoint_policy.run("cpu", _draws(mlr_ref, [0], 80),
                                         verbose=False)
    c, x0 = find(r"c = (\S+); ‖x⁰−x\*‖ ≈ (\S+)", text)
    assert f"{got['c']:.4f}" == c and f"{got['x0_err']:.2f}" == x0
    want = re.findall(r"advise r=(\S+) C=(\d+) \(partial ckpt every (\d+) "
                      r"iters, expected overhead (\S+) ms", text)
    assert len(want) == len(got["advice"]) == 3
    for (_, r, C, every, over), (wr, wC, wevery, wover) in zip(
            got["advice"], want):
        assert (str(r), str(C), str(every)) == (wr, wC, wevery)
        assert f"{over * 1e3:.2f}" == wover


def _literal(s: str):
    return ast.literal_eval(s.strip())


def test_correlated_failures_against_reference(mlr_ref):
    text, _ = reference_output("correlated_failures")
    got = correlated_failures.run("cpu", _draws(mlr_ref, range(4), 120),
                                  verbose=False)
    assert got["trace_kinds"] == _literal(
        find(r"MTBF trace over 2000 steps: (\{[^}]*\})", text)[0])
    for name, sq, cost, tiers in got["host_loss"]:
        wsq, wcost, wtiers = find(re.escape(name) + r"\s+(\S+)\s+(\S+)\s+"
                                   r"(\{[^}]*\})", text)
        assert f"{sq:.3e}" == wsq and f"{cost:.1f}" == wcost, name
        assert tiers == _literal(wtiers), name
    for name, cost, sq, per_event in got["soak"]:
        wcost, wsq, wper = find(re.escape(name) + r"\s+(\S+)\s+(\S+)\s+"
                                 r"(\[.*\])", text)
        assert f"{cost:.1f}" == wcost and f"{sq:.3e}" == wsq, name
        assert per_event == _literal(wper), name
    for name, cost, sq, fallbacks, tiers in got["multi_erasure"]:
        wcost, wsq, wfb, wtiers = find(
            re.escape(name) + r"\s+(\S+)\s+(\S+)\s+(\d+)\s+(\{[^}]*\})", text)
        assert f"{cost:.1f}" == wcost and f"{sq:.3e}" == wsq, name
        assert fallbacks == int(wfb) and tiers == _literal(wtiers), name
