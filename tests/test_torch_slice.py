"""The fabric-less SCAR loop, port against reference, on MLR.

The test runs the loop of ``run_with_failure`` step by step in both
packages. Both get the reference's inputs: its init params, its batch
draws (``jax.random.choice`` on the reference's keys), its failure mask
(``FTController.sample_failure``) and its ``eps`` and ``x_star``. Then:

- every save mask is equal;
- the checkpoint values agree within rtol 1e-5;
- ``partial_sq``, ``full_sq`` and ``applied_sq`` agree within rtol 1e-4;
- losses agree within rtol 1e-4;
- the SCAR and traditional iteration costs are equal.

``CheckpointPolicy.scar(0.25, 32)`` runs with its default 128-row blocks
(2 blocks on this MLR) and again with 8-row blocks (9 blocks, so the
PRIORITY selection has real choices to make), each through the in-place
save and through ``inplace_save=False``.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core.controller import FTController as JController
from repro.core.iteration_cost import empirical_iteration_cost as j_cost
from repro.core.policy import CheckpointPolicy as JPolicy
from repro.models import classic as jclassic
from repro.training import classic_runner as jrunner
from repro_torch.core.controller import FTController as TController
from repro_torch.core.iteration_cost import empirical_iteration_cost as t_cost
from repro_torch.core.policy import CheckpointPolicy as TPolicy
from repro_torch.interop import from_numpy_tree, to_numpy_tree
from repro_torch.models import classic as tclassic
from repro_torch.training import classic_runner as trunner
from repro_torch.utils.tree import tree_leaves

KW = dict(n=400, dim=64, n_classes=5, batch=100)
SEED, MAX_ITERS, FAIL_ITER, FAIL_FRACTION = 0, 100, 25, 0.5


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def models():
    ref = jclassic.make_model("mlr", **KW)
    star = from_numpy_tree(_np(ref.x_star()), "cpu")
    port = dataclasses.replace(
        tclassic.make_model("mlr", device="cpu", **KW), eps=ref.eps,
        x_star=lambda: star)
    clean_ref = jrunner.run_clean(ref, MAX_ITERS, SEED)["losses"]
    return ref, port, clean_ref


def _draw(i):
    key = jax.random.fold_in(jax.random.PRNGKey(SEED), i)
    idx = jax.random.choice(key, KW["n"], (KW["batch"],), replace=False)
    return key, torch.from_numpy(np.asarray(idx).astype(np.int64))


def _close(got_tree, want_tree, rtol):
    for g, w in zip(tree_leaves(to_numpy_tree(got_tree)),
                    jax.tree_util.tree_leaves(_np(want_tree))):
        np.testing.assert_allclose(g, w, rtol=rtol,
                                   atol=rtol * float(np.max(np.abs(w))))


def _run_both(models, jpol, tpol, inplace):
    ref, port, _ = models
    p_ref = ref.init(jax.random.PRNGKey(1))
    p_port = from_numpy_tree(_np(p_ref), "cpu")
    ctl_ref = JController(p_ref, jpol, norm_aux=ref.norm_aux,
                          rng=jax.random.PRNGKey(SEED + 13),
                          colocate=ref.colocate, inplace_save=inplace)
    ctl_port = TController(p_port, tpol, norm_aux=port.norm_aux,
                           colocate=port.colocate, inplace_save=inplace,
                           device="cpu")
    losses_ref, losses_port, saves = [], [], 0
    for i in range(1, MAX_ITERS + 1):
        key, idx = _draw(i)
        p_ref = ref.step(p_ref, key, i)
        p_port = port.update(p_port, idx, i)
        assert ctl_port.should_checkpoint(i) == ctl_ref.should_checkpoint(i)
        if ctl_ref.should_checkpoint(i):
            m_ref = ctl_ref.checkpoint_now(i, p_ref)
            m_port = ctl_port.checkpoint_now(i, p_port)
            np.testing.assert_array_equal(m_port.numpy(), np.asarray(m_ref))
            _close(ctl_port.ckpt.values, ctl_ref.ckpt.values, 1e-5)
            np.testing.assert_array_equal(ctl_port.ckpt.saved_iter.numpy(),
                                          np.asarray(ctl_ref.ckpt.saved_iter))
            saves += 1
        if i == FAIL_ITER:
            lost = ctl_ref.sample_failure(FAIL_FRACTION)
            p_ref, info_ref = ctl_ref.on_failure(p_ref, lost, step=i)
            p_port, info_port = ctl_port.on_failure(
                p_port, torch.from_numpy(np.array(lost)), step=i)
            assert info_port["lost_blocks"] == info_ref["lost_blocks"]
            for k in ("partial_sq", "full_sq", "applied_sq"):
                np.testing.assert_allclose(info_port[k], info_ref[k],
                                           rtol=1e-4)
        losses_ref.append(float(ref.loss(p_ref)))
        losses_port.append(float(port.loss(p_port)))
    assert saves > 0
    assert ctl_port.stats["saves"] == ctl_ref.stats["saves"]
    assert ctl_port.stats["blocks_saved"] == ctl_ref.stats["blocks_saved"]
    assert ctl_port.stats["save_bytes_moved"] == \
        ctl_ref.stats["save_bytes_moved"]
    np.testing.assert_allclose(losses_port, losses_ref, rtol=1e-4)
    return losses_ref, losses_port


def _clean_port(port):
    p = from_numpy_tree(_np(jclassic.make_model("mlr", **KW).init(
        jax.random.PRNGKey(1))), "cpu")
    losses = []
    for i in range(1, MAX_ITERS + 1):
        p = port.update(p, _draw(i)[1], i)
        losses.append(float(port.loss(p)))
    return losses


@pytest.mark.parametrize("inplace", [True, False])
@pytest.mark.parametrize("block_rows", [128, 8])
def test_scar_loop_matches_reference(models, block_rows, inplace):
    jpol = dataclasses.replace(JPolicy.scar(0.25, 32), block_rows=block_rows)
    tpol = dataclasses.replace(TPolicy.scar(0.25, 32), block_rows=block_rows)
    losses_ref, losses_port = _run_both(models, jpol, tpol, inplace)
    ref, port, clean_ref = models
    clean_port = _clean_port(port)
    np.testing.assert_allclose(clean_port, clean_ref, rtol=1e-4)
    assert t_cost(losses_port, clean_port, port.eps) == \
        j_cost(losses_ref, clean_ref, ref.eps)


def test_traditional_loop_matches_reference(models):
    losses_ref, losses_port = _run_both(
        models, JPolicy.traditional(32), TPolicy.traditional(32), True)
    ref, port, clean_ref = models
    clean_port = _clean_port(port)
    assert t_cost(losses_port, clean_port, port.eps) == \
        j_cost(losses_ref, clean_ref, ref.eps)


def test_port_run_with_failure_end_to_end(models):
    ref, port, clean_ref = models
    policy = TPolicy.scar(0.25, 32)
    got = trunner.run_with_failure(port, policy, fail_iter=FAIL_ITER,
                                   fail_fraction=FAIL_FRACTION,
                                   max_iters=60, device="cpu")
    want = jrunner.run_with_failure(ref, JPolicy.scar(0.25, 32),
                                    fail_iter=FAIL_ITER,
                                    fail_fraction=FAIL_FRACTION,
                                    max_iters=60)
    assert set(got) == set(want)
    assert set(got["recovery"]) <= set(want["recovery"])
    assert set(got["controller_stats"]) == set(want["controller_stats"])
    assert len(got["losses"]) == 60 and np.all(np.isfinite(got["losses"]))
    assert got["controller_stats"]["recoveries"] == 1
    assert got["controller_stats"]["saves"] == 60 // policy.partial_interval
