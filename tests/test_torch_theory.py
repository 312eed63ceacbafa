"""The port's iteration-cost theory and policies against the JAX package's.

``delta_T``, ``discounted_delta`` and ``iteration_cost_bound`` run through
``jnp`` in float32 in the reference; the port keeps float32 there and is
held to rtol 1e-6. The pure numpy and ``math`` functions are held to
1e-12.
"""
import numpy as np
import pytest

from repro.core import iteration_cost as jic
from repro.core.policy import CheckpointPolicy as JPolicy
from repro_torch.core import iteration_cost as tic
from repro_torch.core.policy import CheckpointPolicy as TPolicy


def _deltas(seed, n, sparse=True):
    rng = np.random.default_rng(seed)
    d = rng.exponential(size=n).astype(np.float32)
    if sparse:
        d[rng.random(n) < 0.7] = 0.0
    return d


@pytest.mark.parametrize("seed,n", [(0, 1), (1, 10), (2, 60), (3, 150)])
@pytest.mark.parametrize("c", [0.5, 0.9, 0.97])
def test_float32_bounds_agree(seed, n, c):
    d = _deltas(seed, n)
    np.testing.assert_allclose(tic.delta_T(d, c), np.asarray(jic.delta_T(d, c)),
                               rtol=1e-6)
    k = n + 7
    np.testing.assert_allclose(tic.discounted_delta(d, c, k),
                               np.asarray(jic.discounted_delta(d, c, k)),
                               rtol=1e-6)
    np.testing.assert_allclose(
        tic.iteration_cost_bound(d, c, 3.5),
        np.asarray(jic.iteration_cost_bound(d, c, 3.5)), rtol=1e-6)
    assert tic.delta_T(d, c).dtype == np.float32


def test_float32_bounds_take_lists():
    d = [0.0, 1.0, 0.0, 2.5]
    np.testing.assert_allclose(tic.delta_T(d, 0.8),
                               np.asarray(jic.delta_T(d, 0.8)), rtol=1e-6)


@pytest.mark.parametrize("delta,c,T,x0", [(0.3, 0.9, 25, 4.0),
                                          (1e-3, 0.5, 3, 1.0),
                                          (5.0, 0.99, 100, 20.0)])
def test_scalar_bounds_agree(delta, c, T, x0):
    np.testing.assert_allclose(tic.single_perturbation_bound(delta, c, T, x0),
                               jic.single_perturbation_bound(delta, c, T, x0),
                               rtol=1e-12)
    for eps in (1e-3, 0.5, 10.0):
        got = tic.infinite_perturbation_bound(delta, c, x0, eps)
        want = jic.infinite_perturbation_bound(delta, c, x0, eps)
        assert (got == want == float("inf")) or \
            np.isclose(got, want, rtol=1e-12)
    np.testing.assert_allclose(tic.irreducible_error(delta, c),
                               jic.irreducible_error(delta, c), rtol=1e-12)


@pytest.mark.parametrize("burn_in", [0, 3])
def test_trajectory_functions_agree(burn_in):
    rng = np.random.default_rng(9)
    errs = 5.0 * 0.93 ** np.arange(80) * (1 + 0.05 * rng.random(80))
    errs[10] = 0.0
    np.testing.assert_allclose(tic.estimate_contraction(errs, burn_in),
                               jic.estimate_contraction(errs, burn_in),
                               rtol=1e-12)
    clean = errs * 0.9
    for eps in (0.5, 1e-9):
        assert tic.iterations_to_eps(errs, eps) == \
            jic.iterations_to_eps(errs, eps)
        assert tic.empirical_iteration_cost(errs, clean, eps) == \
            jic.empirical_iteration_cost(errs, clean, eps)


@pytest.mark.parametrize("alpha0,G,eps", [(0.5, 1.0, 0.5), (2.0, 0.1, 0.05),
                                          (0.9, 3.0, 1e-6)])
def test_sgd_bound_agrees(alpha0, G, eps):
    d = _deltas(4, 20).astype(np.float64)
    assert tic.sgd_iteration_bound(d, alpha0, G, 2.0, eps, max_k=20000) == \
        jic.sgd_iteration_bound(d, alpha0, G, 2.0, eps, max_k=20000)


@pytest.mark.parametrize("factory,args", [
    ("scar", ()), ("scar", (0.25, 32)), ("scar", (0.3, 5, "scaled_tv")),
    ("traditional", ()), ("traditional", (32,))])
def test_policy_intervals_match(factory, args):
    j = getattr(JPolicy, factory)(*args)
    t = getattr(TPolicy, factory)(*args)
    assert t.partial_interval == j.partial_interval
    assert (t.fraction, t.full_interval, t.strategy.value, t.recovery.value,
            t.norm, t.block_rows) == \
        (j.fraction, j.full_interval, j.strategy.value, j.recovery.value,
         j.norm, j.block_rows)


def test_policy_validation_matches():
    for bad in (dict(fraction=0.0), dict(fraction=1.5),
                dict(full_interval=0), dict(block_rows=0)):
        with pytest.raises(ValueError):
            JPolicy(**bad)
        with pytest.raises(ValueError):
            TPolicy(**bad)
