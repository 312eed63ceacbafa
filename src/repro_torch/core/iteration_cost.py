"""Iteration-cost theory (paper §3 and Appendix B).

The port of ``repro.core.iteration_cost``, in numpy and ``math``:

- ``delta_T``                     -- the time-discounted perturbation
                                     aggregate ``Δ_T = Σ_{ℓ=0}^T c^{-ℓ} E||δ_ℓ||``.
- ``iteration_cost_bound``        -- Theorem 3.2:
                                     ``ι ≤ log(1 + Δ_T/||x⁰−x*||) / log(1/c)``.
- ``infinite_perturbation_bound`` -- Appendix B.1 (perturbation every step).
- ``estimate_contraction``        -- empirical fit of the linear rate ``c``.
- ``iterations_to_eps``           -- κ(·, ε) for a measured trajectory.
- ``sgd_iteration_bound``         -- Appendix B.2 sublinear analogue.

The reference computes ``delta_T``, ``discounted_delta`` and
``iteration_cost_bound`` with ``jnp`` in float32; these keep float32 there
so that the two packages give the same numbers. The rest is float64, as in
the reference.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np


def _f32_vector(x) -> np.ndarray:
    # the reference's jnp arithmetic here runs in float32 (64-bit mode off)
    return np.asarray(x, dtype=np.float32)


def _f32_integer_pow(x: float, n: int) -> np.float32:
    """x**n in float32 by binary exponentiation, as ``jnp.power`` computes a
    concrete integer power (``lax.integer_pow``)."""
    x = np.float32(x)
    if n == 0:
        return np.float32(1.0)
    reciprocal, n = n < 0, abs(n)
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else np.float32(acc * x)
        n >>= 1
        if n > 0:
            x = np.float32(x * x)
    if not reciprocal:
        return acc
    with np.errstate(divide="ignore", over="ignore"):   # inf, as jnp gives
        return np.float32(np.float32(1.0) / acc)


def delta_T(delta_norms, c: float) -> np.float32:
    """Δ_T = Σ_{ℓ=0}^{T} c^{-ℓ} E||δ_ℓ|| (Theorem 3.2), as c^{-T} Σ c^{T-ℓ}||δ_ℓ||
    so that no c^{-ℓ} overflows."""
    d = _f32_vector(delta_norms)
    T = d.shape[0] - 1
    ell = np.arange(T + 1, dtype=np.int32)
    weights = np.power(np.float32(c), (T - ell).astype(np.float32))
    total = np.sum(weights * d, dtype=np.float32)
    return np.float32(_f32_integer_pow(c, -T) * total)


def discounted_delta(delta_norms, c: float, k: int) -> np.float32:
    """c^k · Δ_T -- the absolute residual contribution of perturbations at
    iteration k >= T (Lemma A.1 second term)."""
    d = _f32_vector(delta_norms)
    T = d.shape[0] - 1
    ell = np.arange(T + 1, dtype=np.int32)
    w = np.power(np.float32(c), (k - ell).astype(np.float32))
    return np.float32(np.sum(w * d, dtype=np.float32))


def iteration_cost_bound(delta_norms, c: float, x0_err: float) -> np.float32:
    """Theorem 3.2: ι(δ, ε) ≤ log(1 + Δ_T/||x⁰−x*||) / log(1/c)."""
    dT = delta_T(delta_norms, c)
    return np.float32(np.log1p(np.float32(dT / np.float32(x0_err)))
                      / np.log(np.float32(1.0 / c)))


def single_perturbation_bound(delta_norm: float, c: float, T: int, x0_err: float) -> float:
    """One perturbation of size ||δ|| at iteration T (Example 2.3):
    Δ_T = c^{-T}||δ||."""
    dT = (c ** (-T)) * delta_norm
    return float(math.log1p(dT / x0_err) / math.log(1.0 / c))


def infinite_perturbation_bound(delta_bound: float, c: float, x0_err: float, eps: float) -> float:
    """Appendix B.1: perturbations of size ≤ Δ in every iteration.

    ``float('inf')`` when ε is below the irreducible error (c/(1−c))Δ or the
    bound is uninformative.
    """
    irreducible = (c / (1.0 - c)) * delta_bound
    if eps <= irreducible or x0_err <= irreducible:
        return float("inf")
    num = 1.0 - irreducible / x0_err
    den = 1.0 - irreducible / eps
    return math.log(num / den) / math.log(1.0 / c)


def irreducible_error(delta_bound: float, c: float) -> float:
    """Appendix B.1 irreducible error (c/(1−c))·Δ."""
    return (c / (1.0 - c)) * delta_bound


def estimate_contraction(errors: Sequence[float], burn_in: int = 0) -> float:
    """Fit the linear rate c from an error trajectory ||x^{(k)} − x*||:
    least-squares slope of log(err) vs k, ignoring the first ``burn_in``
    iterations and non-positive errors, clipped into (0, 1)."""
    errs = np.asarray(errors, dtype=np.float64)[burn_in:]
    mask = errs > 0
    ks = np.arange(errs.shape[0], dtype=np.float64)[mask]
    logs = np.log(errs[mask])
    if ks.shape[0] < 2:
        raise ValueError("need at least two positive error observations")
    slope = np.polyfit(ks, logs, 1)[0]
    c = float(np.exp(slope))
    return min(max(c, 1e-9), 1.0 - 1e-9)


def iterations_to_eps(errors: Sequence[float], eps: float) -> int:
    """κ(a, ε): first iteration with error < ε, else len(errors)."""
    errs = np.asarray(errors)
    hits = np.nonzero(errs < eps)[0]
    return int(hits[0]) if hits.size else int(errs.shape[0])


def empirical_iteration_cost(perturbed_errors: Sequence[float],
                             clean_errors: Sequence[float],
                             eps: float) -> int:
    """Measured ι = κ(y, ε) − κ(x, ε) from two error trajectories."""
    return iterations_to_eps(perturbed_errors, eps) - iterations_to_eps(clean_errors, eps)


def sgd_iteration_bound(delta_norms,
                        alpha0: float,
                        G: float,
                        x0_err: float,
                        eps: float,
                        max_k: int = 1_000_000) -> int:
    """Appendix B.2: sublinear (SGD, α_k = α₀/k) analogue of Theorem 3.2,
    solved numerically for the smallest k meeting ε; ``max_k`` if
    unreachable."""
    deltas = np.asarray(delta_norms, dtype=np.float64)
    T = deltas.shape[0]
    a = 1.0
    bracket = float(x0_err)
    for k in range(1, T + 1):
        alpha = min(alpha0 / k, 0.999)
        a *= (1.0 - alpha)
        bracket += (deltas[k - 1] + alpha * alpha * G * G) / a
    k = T
    while k < max_k:
        if a * bracket < eps:
            return k
        k += 1
        alpha = min(alpha0 / k, 0.999)
        a *= (1.0 - alpha)
    return max_k
