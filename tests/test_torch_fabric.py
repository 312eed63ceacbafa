"""The checkpoint fabric and the controller's arena mode, port against
reference.

- **The quickstart path.** ``run_with_failure``'s loop with
  ``fabric=FabricConfig()`` on MLR (``examples/quickstart.py``'s model and
  policy), step by step in both packages, both fed the reference's init,
  batch draws and failure (a uniform mask, or a whole host drawn from the
  same numpy seed): checkpoint stamps and values, tier counts, iteration
  cost, ``maintain_bytes_moved`` and every other fabric counter equal;
  ``applied_sq``/``partial_sq``/``full_sq`` within rtol 1e-4; losses
  within rtol 1e-4 (the two frameworks order their matmuls differently).
- **Trace soaks.** ``run_with_trace`` on ``examples/correlated_failures.py``'s
  double-host trace, elastic on and off, and a three-host trace with
  heals: per-event tier counts and placement, and the availability
  summary, equal. Tier planning depends on placement and freshness only,
  so each package runs with its own draws.
- **PARITY at the controller.** Losing block 0's primary and replica
  homes sends blocks to the PARITY tier; both packages plan the same
  tiers and recover the same values bit for bit, and the PARITY and
  PEER_REPLICA blocks come back as their live values.
- Placement (domains, MTBF traces, replica, checkpoint-cache and parity
  homes) stays equal through elastic failures and heals.
- One-tier fabrics (``replicate=False`` or ``parity=False``) run the
  per-component passes and recover a host loss as the reference does.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.controller import FTController as JController
from repro.core.iteration_cost import empirical_iteration_cost as j_cost
from repro.core.policy import CheckpointPolicy as JPolicy
from repro.core.policy import RecoveryMode as JRecovery
from repro.core.policy import SelectionStrategy as JStrategy
from repro.fabric import FabricConfig as JFabricConfig
from repro.fabric import FailureEvent as JEvent
from repro.models import classic as jclassic
from repro.training import classic_runner as jrunner
from repro_torch.core.controller import FTController as TController
from repro_torch.core.iteration_cost import empirical_iteration_cost as t_cost
from repro_torch.core.policy import CheckpointPolicy as TPolicy
from repro_torch.core.policy import RecoveryMode as TRecovery
from repro_torch.core.policy import SelectionStrategy as TStrategy
from repro_torch.fabric import FabricConfig as TFabricConfig
from repro_torch.fabric import FailureEvent as TEvent
from repro_torch.interop import from_numpy_tree, to_numpy_tree
from repro_torch.models import classic as tclassic
from repro_torch.training import classic_runner as trunner
from repro_torch.utils.tree import tree_leaves

KW = dict(n=600, dim=64, n_classes=5, batch=200)   # examples/quickstart.py
SEED, MAX_ITERS, FAIL_ITER = 0, 80, 25


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while these tests run: the suite runs several
    workers on a few cores, and torch's default of one thread per core in
    each of them oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def models():
    ref = jclassic.make_model("mlr", **KW)
    port = dataclasses.replace(
        tclassic.make_model("mlr", device="cpu", **KW), eps=ref.eps)
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


def _step(ctl, i, p):
    """run_with_failure's per-iteration fault-tolerance work (both
    packages share the arena-state interface)."""
    packed = ctl.arena_ready and ctl.live_value_needed(i)
    live = ctl.pack_live(p, account=True) if packed else p
    ctl.maintain(i, live, own_live=packed)
    ctl.maybe_checkpoint(i, live, own_live=packed)


QUICKSTART = [(128, "priority", "uniform"), (8, "priority", "uniform"),
              (8, "round", "uniform"), (8, "priority", "host")]


@pytest.mark.parametrize("block_rows,strategy,fail", QUICKSTART)
def test_quickstart_fabric_loop_matches_reference(models, block_rows,
                                                  strategy, fail):
    ref, port, clean_ref = models
    jpol = dataclasses.replace(JPolicy.scar(0.25, 32), block_rows=block_rows,
                               strategy=JStrategy(strategy))
    tpol = dataclasses.replace(TPolicy.scar(0.25, 32), block_rows=block_rows,
                               strategy=TStrategy(strategy))
    p_ref = ref.init(jax.random.PRNGKey(1))
    p_port = from_numpy_tree(_np(p_ref), "cpu")
    ctl_ref = JController(p_ref, jpol, norm_aux=ref.norm_aux,
                          rng=jax.random.PRNGKey(SEED + 13),
                          fabric=JFabricConfig())
    ctl_port = TController(p_port, tpol, norm_aux=port.norm_aux,
                           rng=torch.Generator().manual_seed(SEED + 13),
                           fabric=TFabricConfig(), device="cpu")
    assert ctl_port.arena_ready and ctl_ref.arena_ready
    losses_ref, losses_port = [], []
    for i in range(1, MAX_ITERS + 1):
        key, idx = _draw(i)
        p_ref = ref.step(p_ref, key, i)
        p_port = port.update(p_port, idx, i)
        _step(ctl_ref, i, p_ref)
        _step(ctl_port, i, p_port)
        np.testing.assert_array_equal(ctl_port.ckpt.saved_iter.numpy(),
                                      np.asarray(ctl_ref.ckpt.saved_iter))
        if i == FAIL_ITER:
            if fail == "uniform":
                lost = np.asarray(ctl_ref.sample_failure(0.5))
                failed = None
            else:
                lost, failed = ctl_ref.sample_domain_failure(fail)
                t_lost, t_failed = ctl_port.sample_domain_failure(fail)
                np.testing.assert_array_equal(t_lost, lost)
                np.testing.assert_array_equal(t_failed, failed)
            p_ref, info_ref = ctl_ref.on_failure(p_ref, lost, step=i,
                                                 failed_devices=failed)
            p_port, info_port = ctl_port.on_failure(
                p_port, torch.from_numpy(np.array(lost)), step=i,
                failed_devices=failed)
            assert info_port["tier_counts"] == info_ref["tier_counts"]
            assert info_port["lost_blocks"] == info_ref["lost_blocks"]
            for k in ("partial_sq", "full_sq", "applied_sq"):
                np.testing.assert_allclose(info_port[k], info_ref[k],
                                           rtol=1e-4, atol=1e-12)
            assert set(info_port) == set(info_ref) - {"placement"} \
                or set(info_port) == set(info_ref)
        losses_ref.append(float(ref.loss(p_ref)))
        losses_port.append(float(port.loss(p_port)))
    _close(ctl_port.ckpt.values, ctl_ref.ckpt.values, 1e-5)
    for k in ("saves", "blocks_saved", "save_bytes_moved"):
        assert ctl_port.stats[k] == ctl_ref.stats[k], k
    fs_ref, fs_port = ctl_ref.fabric.stats, ctl_port.fabric.stats
    assert set(fs_port) == set(fs_ref)
    for k in fs_ref:
        if k == "arena_padding_ratio":
            assert fs_port[k] == pytest.approx(fs_ref[k], rel=1e-12)
        else:
            assert fs_port[k] == fs_ref[k], k
    np.testing.assert_allclose(losses_port, losses_ref, rtol=1e-4)
    clean_port = []
    p = from_numpy_tree(_np(ref.init(jax.random.PRNGKey(1))), "cpu")
    for i in range(1, MAX_ITERS + 1):
        p = port.update(p, _draw(i)[1], i)
        clean_port.append(float(port.loss(p)))
    assert t_cost(losses_port, clean_port, port.eps) == \
        j_cost(losses_ref, clean_ref, ref.eps)


def test_port_quickstart_run_with_failure(models):
    """The port's own runner on the quickstart path: every key of the
    reference's result, finite losses, one PEER_REPLICA recovery at zero
    perturbation (a uniform loss leaves every tier alive)."""
    ref, port, _ = models
    got = trunner.run_with_failure(
        port, TPolicy.scar(fraction=0.25, interval=32), fail_iter=FAIL_ITER,
        fail_fraction=0.5, max_iters=40, fabric=TFabricConfig(),
        device="cpu")
    want = jrunner.run_with_failure(
        ref, JPolicy.scar(fraction=0.25, interval=32), fail_iter=FAIL_ITER,
        fail_fraction=0.5, max_iters=40, fabric=JFabricConfig())
    assert set(got) == set(want)
    assert set(got["fabric_stats"]) == set(want["fabric_stats"])
    assert got["arena_state"] and np.all(np.isfinite(got["losses"]))
    assert got["recovery"]["tier_counts"] == want["recovery"]["tier_counts"]
    assert got["recovery"]["applied_sq"] == 0.0
    assert got["fabric_stats"]["maintain_bytes_moved"] == \
        want["fabric_stats"]["maintain_bytes_moved"]


def _soak_policy(block_rows):
    kw = dict(fraction=0.25, full_interval=8, block_rows=block_rows)
    return (JPolicy(strategy=JStrategy.ROUND_ROBIN,
                    recovery=JRecovery.PARTIAL, **kw),
            TPolicy(strategy=TStrategy.ROUND_ROBIN,
                    recovery=TRecovery.PARTIAL, **kw))


TRACES = {
    "double_host": ([("host", 0, 15), ("host", 2, 15)], None, 20),
    "three_hosts_heal": ([("host", 0, 5), ("host", 1, 10), ("host", 2, 15)],
                         3, 24),
}


@pytest.mark.parametrize("trace", sorted(TRACES))
@pytest.mark.parametrize("elastic", [False, True])
def test_run_with_trace_matches_reference(models, trace, elastic):
    ref, port, _ = models
    events, heal_after, iters = TRACES[trace]
    jpol, tpol = _soak_policy(ref.block_rows)
    topo = dict(n_devices=8, devices_per_host=2, hosts_per_rack=2,
                elastic=elastic)
    want = jrunner.run_with_trace(
        ref, jpol, max_iters=iters, seed=0, heal_after=heal_after,
        clean_losses=[1.0] * iters,
        trace=[JEvent(step=s, kind=k, index=i) for k, i, s in events],
        fabric=JFabricConfig(**topo))
    got = trunner.run_with_trace(
        port, tpol, max_iters=iters, seed=0, heal_after=heal_after,
        clean_losses=[1.0] * iters,
        trace=[TEvent(step=s, kind=k, index=i) for k, i, s in events],
        fabric=TFabricConfig(**topo), device="cpu")
    assert len(got["events"]) == len(want["events"])
    for g, w in zip(got["events"], want["events"]):
        assert g.get("skipped") == w.get("skipped")
        assert g.get("tier_counts") == w.get("tier_counts")
        assert g.get("placement") == w.get("placement")
        assert g.get("events") == w.get("events")
        assert len(g.get("tier_fallbacks", [])) == \
            len(w.get("tier_fallbacks", []))
    assert got["availability"] == want["availability"]
    for k in ("rehomes", "heals", "recoveries", "replica_refreshes",
              "parity_encodes", "arena_maintains", "tier_fallbacks",
              "maintain_bytes_moved"):
        assert got["fabric_stats"][k] == want["fabric_stats"][k], k


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"big": rng.normal(size=(64, 300)).astype(np.float32),
            "w": rng.normal(size=(96, 12)).astype(np.float32),
            "b": rng.normal(size=(5,)).astype(np.float32)}


@pytest.mark.parametrize("elastic", [False, True])
def test_controller_parity_tier_matches_reference(elastic):
    """Four drift steps of maintain + PRIORITY 1/8 saves, then the loss of
    block 0's primary home and its replica home (tests/test_arena.py's
    PARITY case, at the controller)."""
    np_tree = _tree()
    jt = {k: jnp.asarray(v) for k, v in np_tree.items()}
    tt = from_numpy_tree(np_tree, "cpu")
    pol = dict(fraction=0.125, full_interval=1, block_rows=8)
    ctl_ref = JController(jt, JPolicy(strategy=JStrategy.PRIORITY, **pol),
                          fabric=JFabricConfig(elastic=elastic))
    ctl_port = TController(tt, TPolicy(strategy=TStrategy.PRIORITY, **pol),
                           fabric=TFabricConfig(elastic=elastic),
                           device="cpu")
    rng = np.random.default_rng(1)
    for step in range(1, 5):
        noise = {k: (1e-2 * rng.normal(size=v.shape)).astype(np.float32)
                 for k, v in np_tree.items()}
        jt = {k: jt[k] + noise[k] for k in jt}
        tt = {k: tt[k] + torch.from_numpy(noise[k]) for k in tt}
        for ctl, p in ((ctl_ref, jt), (ctl_port, tt)):
            ctl.maintain(step, p)
            assert ctl.maybe_checkpoint(step, p)
        np.testing.assert_array_equal(ctl_port.ckpt.saved_iter.numpy(),
                                      np.asarray(ctl_ref.ckpt.saved_iter))
    fab = ctl_port.fabric
    failed = np.unique(np.asarray([fab.view.homes[0],
                                   fab.replicas.replica_homes[0]], np.int32))
    lost = np.isin(fab.view.homes, failed)
    rec_ref, info_ref = ctl_ref.on_failure(jt, lost, failed_devices=failed,
                                           step=4)
    rec_port, info_port = ctl_port.on_failure(tt, lost, failed_devices=failed,
                                              step=4)
    assert info_port["tier_counts"] == info_ref["tier_counts"]
    assert info_port["tier_counts"]["PARITY"] > 0
    assert info_port["tier_sq"]["PARITY"] == 0.0
    assert info_port["tier_sq"]["PEER_REPLICA"] == 0.0
    assert info_port.get("placement") == info_ref.get("placement")
    for k in np_tree:
        np.testing.assert_array_equal(rec_port[k].numpy(),
                                      np.asarray(rec_ref[k]))
    for ctl in (ctl_ref, ctl_port):
        np.testing.assert_array_equal(np.asarray(ctl.fabric.view.homes),
                                      fab.view.homes)
    np.testing.assert_array_equal(fab.parity.members,
                                  ctl_ref.fabric.parity.members)
    np.testing.assert_array_equal(fab.replicas.replica_homes,
                                  ctl_ref.fabric.replicas.replica_homes)
    assert fab.redundancy_state() == ctl_ref.fabric.redundancy_state()
    assert fab.redundancy_nbytes() == {
        k: v for k, v in ctl_ref.fabric.redundancy_nbytes().items()}


def test_domains_and_traces_equal():
    from repro.fabric.domains import FailureDomainMap as JD
    from repro_torch.fabric.domains import FailureDomainMap as TD
    mtbf = {"device": 30.0, "host": 60.0, "rack": 150.0}
    for n, dph, hpr in ((8, 2, 2), (16, 4, 2), (7, 3, 1)):
        j, t = JD(n, dph, hpr), TD(n, dph, hpr)
        assert (t.n_hosts, t.n_racks) == (j.n_hosts, j.n_racks)
        assert t.sample_failure_trace(np.random.default_rng(5), 400, mtbf) \
            == [TEvent(**vars(e)) for e in j.sample_failure_trace(
                np.random.default_rng(5), 400, mtbf)]
        for kind in ("device", "host", "rack"):
            np.testing.assert_array_equal(
                t.sample_domain_failure(np.random.default_rng(9), kind),
                j.sample_domain_failure(np.random.default_rng(9), kind))


def test_fabric_configs_that_raise():
    """What raises: ``resize_mesh`` on a fabric bound to no mesh (the
    elastic mesh is a sharded-arena operation), a bit flip before any
    arena snapshot exists, a FULL-recovery policy with a fabric. An XOR
    fabric's scrub checks nothing (the reference's answer), and a tree
    the arena cannot pack takes the per-leaf path."""
    part_tree = {"w": torch.zeros(16, 4)}
    from repro_torch.core.blocks import partition_pytree
    from repro_torch.fabric import CheckpointFabric
    part = partition_pytree(part_tree, 8)
    fab = CheckpointFabric(part, TFabricConfig())
    from repro_torch.launch.mesh import survivor_mesh
    with pytest.raises(ValueError, match="meshed fabric only"):
        fab.resize_mesh(survivor_mesh([0]), [0])
    with pytest.raises(RuntimeError, match="arena-mode replica"):
        fab.inject_arena_bit_flip()
    assert fab.scrub() == {"checked": False, "detected": 0, "corrected": 0,
                           "reports": []}
    f64 = CheckpointFabric(partition_pytree(
        {"w": torch.zeros(16, 4, dtype=torch.float64)}, 8))
    assert f64.arena_layout is None
    with pytest.raises(ValueError, match="FULL"):
        TController(part_tree, TPolicy.traditional(), fabric=TFabricConfig(),
                    device="cpu")


@pytest.mark.parametrize("tiers", [dict(replicate=False),
                                   dict(parity=False)])
def test_one_tier_fabrics_match_reference(models, tiers):
    """``examples/correlated_failures.py``'s one-tier variants: without
    both tiers there is no arena sweep, so each step runs the
    per-component passes (a replica tree copy, or a parity encode from a
    pack), and a host loss recovers through the tree paths."""
    ref, port, _ = models
    jpol, tpol = _soak_policy(ref.block_rows)
    topo = dict(n_devices=8, devices_per_host=2, hosts_per_rack=2, **tiers)
    kw = dict(fail_iter=15, fail_fraction=0.5, max_iters=20,
              clean_losses=[1.0] * 20, fail_domain="host")
    want = jrunner.run_with_failure(ref, jpol, fabric=JFabricConfig(**topo),
                                    **kw)
    got = trunner.run_with_failure(port, tpol, fabric=TFabricConfig(**topo),
                                   device="cpu", **kw)
    assert not got["arena_state"] and not want["arena_state"]
    assert got["recovery"]["tier_counts"] == want["recovery"]["tier_counts"]
    assert got["recovery"]["tier_counts"]["PARITY" if "replicate" in tiers
                                          else "PEER_REPLICA"] > 0
    for k in ("replica_refreshes", "parity_encodes", "maintain_bytes_moved",
              "recoveries", "arena_maintains"):
        assert got["fabric_stats"][k] == want["fabric_stats"][k], k
    np.testing.assert_allclose(got["recovery"]["applied_sq"],
                               want["recovery"]["applied_sq"], rtol=1e-4,
                               atol=1e-12)
