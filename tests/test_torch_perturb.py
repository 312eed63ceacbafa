"""The port's perturbations and ``run_with_perturbation``.

The adversarial perturbation is deterministic and is held to the
reference's within rtol 1e-5. The random and reset perturbations draw
from a ``torch.Generator``, so they are held to what they promise: the
requested norm, and the reset blocks taking their initial values.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.perturb import adversarial_perturbation as j_adversarial
from repro.training import classic_runner as jrunner
from repro.models import classic as jclassic
from repro_torch.core.blocks import partition_pytree, tree_sq_norm
from repro_torch.core.perturb import (adversarial_perturbation,
                                      random_perturbation, reset_perturbation)
from repro_torch.interop import from_numpy_tree, to_numpy_tree
from repro_torch.models import classic as tclassic
from repro_torch.training import classic_runner as trunner
from repro_torch.utils.tree import tree_leaves


def _trees():
    rng = np.random.default_rng(2)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    return {"w": f(19, 3), "b": f(3)}, {"w": f(19, 3), "b": f(3)}


def test_adversarial_matches_reference():
    x, star = _trees()
    want, want_n = j_adversarial(jax.tree_util.tree_map(jnp.asarray, x),
                                 jax.tree_util.tree_map(jnp.asarray, star),
                                 0.7)
    got, got_n = adversarial_perturbation(from_numpy_tree(x, "cpu"),
                                          from_numpy_tree(star, "cpu"), 0.7)
    assert float(got_n) == pytest.approx(float(want_n))
    for g, w in zip(tree_leaves(to_numpy_tree(got)),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5, atol=1e-6)


def test_random_perturbation_has_the_requested_norm():
    x, _ = _trees()
    p = from_numpy_tree(x, "cpu")
    out, n = random_perturbation(torch.Generator().manual_seed(3), p, 0.25)
    assert float(n) == pytest.approx(0.25)
    assert float(torch.sqrt(tree_sq_norm(out, p))) == pytest.approx(0.25,
                                                                     rel=1e-4)


def test_reset_perturbation_restores_initial_blocks():
    x, x0 = _trees()
    p, p0 = from_numpy_tree(x, "cpu"), from_numpy_tree(x0, "cpu")
    part = partition_pytree(p, 4)
    out, n = reset_perturbation(torch.Generator().manual_seed(5), p, p0,
                                0.5, part)
    rows_reset = (out["w"] == p0["w"]).all(dim=1)
    assert 0 < int(rows_reset.sum()) < 19
    assert float(n) == pytest.approx(float(torch.sqrt(tree_sq_norm(out, p))))


@pytest.mark.parametrize("kind,kw", [("random", dict(size=0.5)),
                                     ("adversarial", dict(size=0.5)),
                                     ("reset", dict(fraction=0.5))])
def test_run_with_perturbation_end_to_end(kind, kw):
    sizes = dict(n=200, dim=16, n_classes=4, batch=50)
    port = tclassic.make_model("mlr", device="cpu", **sizes)
    got = trunner.run_with_perturbation(port, kind=kind, at_iter=5,
                                        max_iters=30, device="cpu", **kw)
    want = jrunner.run_with_perturbation(jclassic.make_model("mlr", **sizes),
                                         kind=kind, at_iter=5, max_iters=30,
                                         **kw)
    assert set(got) == set(want)
    assert len(got["losses"]) == 30 and np.all(np.isfinite(got["losses"]))
    assert got["delta_norm"] > 0
