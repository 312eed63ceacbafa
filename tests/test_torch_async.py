"""Async maintenance (``FabricConfig(async_maintain=True)``), port against
reference: the two-slot epoch/publish protocol on the CPU, where it runs
without streams (``tests/test_torch_async_gpu.py`` holds its CUDA form).

The reference's ``tests/test_async_maintain.py``, on the port:

- the config gate, and the async traffic model (resident sweep plus one
  snapshot copy; equal to the reference's bytes);
- bit-identity: every-step async maintenance gives the losses, tier
  counts and recovery of the synchronous path (the classic runner and the
  LM trainer, whose checkpoint arena, ``saved_iter`` and final arena are
  equal bit for bit);
- the port's async run held against the reference's async run on the
  reference's inputs (MF's init carried as numpy): checkpoint stamps, the
  published epoch, tier counts, ``recovered_epoch`` and ``staleness``
  equal, losses within rtol 1e-5 and checkpoint values within rtol 1e-5
  (atol 1e-5 of the largest value: the frameworks' solves round
  differently);
- published-epoch recovery: a failure while a sweep is pending settles it
  and restores every lost block bit-exactly; a failure a step past the
  published epoch recovers the stale replica and is priced in the ledger
  with ``recovered_epoch``/``staleness``, as the reference prices it;
- the deferred fences' order (a save, an elastic re-plan, the explicit
  fence), and the trainer's deferred ``maintain`` spans overlapping the
  next ``train_step``;
- a store write that fails raises at ``flush`` with its job's context.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core.controller import FTController as JController
from repro.core.policy import CheckpointPolicy as JPolicy
from repro.core.policy import RecoveryMode as JRecovery
from repro.core.policy import SelectionStrategy as JStrategy
from repro.fabric import FabricConfig as JFabricConfig
from repro.models import classic as jclassic
from repro_torch.checkpoint_io import ShardedCheckpointStore
from repro_torch.configs import get_config
from repro_torch.core.blocks import partition_pytree
from repro_torch.core.controller import FTController
from repro_torch.core.policy import (CheckpointPolicy, RecoveryMode,
                                     SelectionStrategy)
from repro_torch.data import ShardedLMDataset
from repro_torch.fabric import FabricConfig
from repro_torch.interop import from_numpy_tree, to_numpy_tree
from repro_torch.models.classic import make_model
from repro_torch.telemetry.recorder import Recorder
from repro_torch.training import TrainLoop, TrainLoopConfig
from repro_torch.training.classic_runner import run_with_failure
from repro_torch.utils.tree import tree_leaves

MF = dict(m=60, n=80, rank=3)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree_equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))


def _policy(block_rows):
    return CheckpointPolicy(fraction=0.25, full_interval=8,
                            strategy=SelectionStrategy.PRIORITY,
                            recovery=RecoveryMode.PARTIAL,
                            block_rows=block_rows)


def _controller(model, async_maintain: bool, elastic: bool = False,
                recorder=None, seed: int = 0, params=None):
    p = params if params is not None else model.init(
        torch.Generator().manual_seed(1))
    ctl = FTController(p, _policy(model.block_rows), norm_aux=model.norm_aux,
                       rng=torch.Generator().manual_seed(seed + 13),
                       colocate=model.colocate,
                       fabric=FabricConfig(n_devices=8,
                                           async_maintain=async_maintain,
                                           elastic=elastic),
                       recorder=recorder, device="cpu")
    assert ctl.arena_ready
    return p, ctl


def _maintain(model, ctl, p, i):
    """One iteration: the model step, then the pack the fabric adopts."""
    p = model.step(p, None, i)
    ctl.maintain(i, ctl.pack_live(p, account=True), own_live=True)
    return p


def _mf():
    return make_model("mf", device="cpu", **MF)


# ---------------------------------------------------------------------------
# config gate + traffic model
# ---------------------------------------------------------------------------

def test_async_config_requires_fused_arena():
    with pytest.raises(ValueError, match="async_maintain"):
        FabricConfig(async_maintain=True, fused=False)
    with pytest.raises(ValueError, match="async_maintain"):
        FabricConfig(async_maintain=True, arena=False)
    FabricConfig(async_maintain=True)


def test_async_traffic_is_resident_plus_snapshot():
    """arena_async is the resident sweep plus one arena read and write,
    symmetric with arena_owned around it, and equal to the reference's."""
    _, ctl = _controller(_mf(), True)
    t = ctl.fabric._traffic_model()
    assert t["arena_async"] - t["arena_resident"] \
        == t["arena_resident"] - t["arena_owned"] > 0
    ref = jclassic.make_model("mf", **MF)
    jctl = JController(ref.init(jax.random.PRNGKey(1)), JPolicy(
        fraction=0.25, full_interval=8, strategy=JStrategy.PRIORITY,
        recovery=JRecovery.PARTIAL, block_rows=ref.block_rows),
        norm_aux=ref.norm_aux, colocate=ref.colocate,
        fabric=JFabricConfig(n_devices=8, use_pallas=False,
                             async_maintain=True))
    jt = jctl.fabric._traffic_model()
    for k in ("arena_async", "arena_resident", "arena_owned"):
        assert t[k] == jt[k], k


# ---------------------------------------------------------------------------
# bit-identity
# ---------------------------------------------------------------------------

def test_async_classic_every_step_bit_identical():
    """A partial save every iteration, so a consume point every step: the
    async losses and recovery equal the sync run's."""
    model = make_model("mf", device="cpu", m=80, n=120, rank=4)
    pol = dataclasses.replace(CheckpointPolicy.scar(fraction=0.25,
                                                    interval=4),
                              block_rows=model.block_rows)
    kw = dict(fail_iter=10, fail_fraction=0.4, max_iters=20, seed=0,
              fail_domain="host", device="cpu")
    sync = run_with_failure(model, pol, fabric=FabricConfig(n_devices=8),
                            **kw)
    asy = run_with_failure(model, pol, fabric=FabricConfig(
        n_devices=8, async_maintain=True), **kw)
    assert sync["losses"] == asy["losses"]
    assert asy["fabric_stats"]["async_maintains"] == 20
    assert asy["fabric_stats"]["fence_count"] >= 1
    assert asy["recovery"]["tier_counts"] == sync["recovery"]["tier_counts"]
    assert asy["recovery"]["recovered_epoch"] == 10
    assert asy["recovery"]["staleness"] == 0


def test_async_port_matches_reference_on_its_inputs():
    """MF from the reference's init (carried as numpy), async in both
    packages, a host lost at step 6 mid-sweep: checkpoint stamps, the
    published epoch, tier counts and the epoch accounting equal; losses
    and the running checkpoint within rtol 1e-5 (the checkpoint's atol
    1e-5 of its largest value)."""
    ref = jclassic.make_model("mf", **MF)
    port = dataclasses.replace(_mf(), eps=ref.eps)
    p_ref = ref.init(jax.random.PRNGKey(1))
    p_port = from_numpy_tree(jax.tree_util.tree_map(np.asarray, p_ref),
                             "cpu")
    jpol = JPolicy(fraction=0.25, full_interval=8,
                   strategy=JStrategy.PRIORITY, recovery=JRecovery.PARTIAL,
                   block_rows=ref.block_rows)
    jctl = JController(p_ref, jpol, norm_aux=ref.norm_aux,
                       colocate=ref.colocate,
                       fabric=JFabricConfig(n_devices=8, use_pallas=False,
                                            async_maintain=True))
    _, tctl = _controller(port, True, params=p_port)
    key = jax.random.PRNGKey(0)
    losses = {"ref": [], "port": []}
    for i in range(1, 9):
        p_ref = ref.step(p_ref, jax.random.fold_in(key, i), i)
        jl = jctl.pack_live(p_ref, account=True)
        jctl.maintain(i, jl, own_live=True)
        jctl.maybe_checkpoint(i, jl, own_live=True)
        p_port = port.step(p_port, None, i)
        tl = tctl.pack_live(p_port, account=True)
        tctl.maintain(i, tl, own_live=True)
        tctl.maybe_checkpoint(i, tl, own_live=True)
        assert tctl.fabric.published_epoch == jctl.fabric.published_epoch
        assert tctl.fabric.has_pending_maintenance \
            == jctl.fabric.has_pending_maintenance
        np.testing.assert_array_equal(tctl.ckpt.saved_iter.numpy(),
                                      np.asarray(jctl.ckpt.saved_iter))
        if i == 6:
            lost, failed = jctl.sample_domain_failure("host")
            p_ref, jinfo = jctl.on_failure(p_ref, lost,
                                           failed_devices=failed, step=i)
            p_port, tinfo = tctl.on_failure(p_port, lost,
                                            failed_devices=failed, step=i)
            assert tinfo["tier_counts"] == jinfo["tier_counts"]
            for k in ("recovered_epoch", "staleness", "lost_blocks",
                      "failed_devices"):
                assert tinfo[k] == jinfo[k], k
        losses["ref"].append(float(ref.loss(p_ref)))
        losses["port"].append(float(port.loss(p_port)))
    np.testing.assert_allclose(losses["port"], losses["ref"], rtol=1e-5)
    for g, w in zip(tree_leaves(to_numpy_tree(tctl.ckpt.values)),
                    jax.tree_util.tree_leaves(jctl.ckpt.values)):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=1e-5,
                                   atol=1e-5 * float(np.max(np.abs(w))))
    for k in ("async_maintains", "fence_count", "arena_maintains",
              "maintain_bytes_moved"):
        assert tctl.fabric.stats[k] == jctl.fabric.stats[k], k


# ---------------------------------------------------------------------------
# published-epoch recovery
# ---------------------------------------------------------------------------

def test_mid_sweep_failure_recovers_from_published_epoch():
    """A failure while epoch 3's sweep is pending: it settles first, and
    every lost block comes back bit-exactly from the published replica."""
    model = _mf()
    p, ctl = _controller(model, True)
    fab = ctl.fabric
    for i in range(1, 4):
        p = _maintain(model, ctl, p, i)
    assert fab.has_pending_maintenance and fab.published_epoch == 3
    lost = ctl.sample_failure(0.5)
    p2, info = ctl.on_failure(p, lost, step=3)
    assert not fab.has_pending_maintenance
    assert info["recovered_epoch"] == 3 and info["staleness"] == 0
    assert info["tier_counts"]["PEER_REPLICA"] == int(lost.sum())
    assert info["applied_sq"] == 0.0
    assert _tree_equal(p2, p)


def test_stale_published_epoch_priced_explicitly():
    """A failure one step past the published epoch: the stale replica
    still serves, and recovered_epoch/staleness reach the recovery stats
    and the ledger entry."""
    model = _mf()
    rec = Recorder()
    p, ctl = _controller(model, True, recorder=rec)
    for i in range(1, 4):
        p = _maintain(model, ctl, p, i)
    p = model.step(p, None, 4)          # no maintain: live at 4, published 3
    assert ctl.fabric.replicas.staleness(4) == 1
    lost = ctl.sample_failure(0.5)
    _, info = ctl.on_failure(p, lost, step=4)
    assert info["recovered_epoch"] == 3 and info["staleness"] == 1
    assert info["tier_counts"]["PEER_REPLICA"] == int(lost.sum())
    assert info["applied_sq"] > 0.0
    entry = rec.ledger.entries[-1]
    assert entry.extra["recovered_epoch"] == 3
    assert entry.extra["staleness"] == 1
    # the sync fabric restores the same stale values but prices them as
    # the failure's own step
    p_s, ctl_s = _controller(model, False)
    for i in range(1, 4):
        p_s = _maintain(model, ctl_s, p_s, i)
    p_s = model.step(p_s, None, 4)
    _, info_s = ctl_s.on_failure(p_s, lost, step=4)
    assert info_s["recovered_epoch"] == 4 and info_s["staleness"] == 0
    assert info_s["applied_sq"] == info["applied_sq"]


# ---------------------------------------------------------------------------
# deferred fence ordering
# ---------------------------------------------------------------------------

def test_deferred_fence_ordering_under_checkpoint_and_replan():
    model = _mf()
    p, ctl = _controller(model, True, elastic=True)
    fab = ctl.fabric
    p = model.step(p, None, 1)
    live = ctl.pack_live(p, account=True)
    ctl.maintain(1, live, own_live=True)
    assert fab.has_pending_maintenance
    ctl.checkpoint_now(1, live)          # consume point 1: the save
    assert not fab.has_pending_maintenance
    p = _maintain(model, ctl, p, 2)
    assert fab.has_pending_maintenance
    lost, failed = ctl.sample_domain_failure("host")
    p2, info = ctl.on_failure(p, lost, failed_devices=failed, step=2)
    assert not fab.has_pending_maintenance   # consume point 2: the re-plan
    assert info["placement"]["rehomed_blocks"] >= 0
    assert fab.published_epoch == 2
    _maintain(model, ctl, p2, 3)
    assert fab.has_pending_maintenance
    fab.block_until_maintained()         # consume point 3: the fence
    assert not fab.has_pending_maintenance
    assert fab.stats["fence_count"] == 3
    assert fab.fence_hist.summary()["count"] == 3


# ---------------------------------------------------------------------------
# LM loop: bit-identity + span overlap
# ---------------------------------------------------------------------------

def _lm_loop(async_maintain: bool, store=None):
    cfg = get_config("qwen2-1.5b", reduced=True)
    # every-step maintenance, a partial save every 4 steps
    pol = CheckpointPolicy(fraction=0.25, full_interval=16,
                           strategy=SelectionStrategy.PRIORITY,
                           recovery=RecoveryMode.PARTIAL)
    rec = Recorder()
    loop = TrainLoop(cfg, loop_cfg=TrainLoopConfig(
        policy=pol, fabric=FabricConfig(async_maintain=async_maintain),
        arena_state=True, recorder=rec), store=store, device="cpu")
    state = loop.init_state()
    return loop, state, ShardedLMDataset(cfg, 2, 32, device="cpu"), rec


def test_async_lm_bit_identical_and_spans_overlap(tmp_path):
    ls, ss, dss, _ = _lm_loop(False)
    la, sa, dsa, rec = _lm_loop(True, store=ShardedCheckpointStore(
        str(tmp_path), device="cpu"))
    ss = ls.run(ss, iter(dss), 10)
    sa = la.run(sa, iter(dsa), 10)
    assert [m["loss"] for m in ls.metrics] == [m["loss"] for m in la.metrics]
    assert torch.equal(ls.controller._ckpt_arena, la.controller._ckpt_arena)
    assert torch.equal(ls.controller.ckpt.saved_iter,
                       la.controller.ckpt.saved_iter)
    assert torch.equal(ss.arena, sa.arena)
    # the store the async run mirrored holds its running checkpoint
    assert _tree_equal(la.controller.store.read_all(),
                       la.controller.ckpt.values)
    fab = la.controller.fabric
    assert fab.stats["async_maintains"] == 10
    assert not fab.has_pending_maintenance   # the end-of-run fence ran
    trains = rec.tracer.intervals("train_step")
    maints = rec.tracer.intervals("maintain")
    assert len(maints) == 10
    assert sum(any(m0 < t1 and t0 < m1 for (t0, t1) in trains)
               for (m0, m1) in maints) >= 1
    deferred = [s for s in rec.tracer.spans
                if s.name == "maintain" and s.args.get("deferred")]
    assert len(deferred) == 10
    assert all(s.args["mode"] == "arena_async" for s in deferred)
    out = la.overhead_summary()
    assert set(out["phases"]) == {"sweep", "save", "fence"}
    assert out["phases"]["fence"]["count"] >= 1
    assert 0.0 < out["overlap_efficiency"] <= 1.0
    assert out["async_maintains"] == 10
    assert rec.gauges["fabric/overlap_efficiency"].value \
        == out["overlap_efficiency"]
    assert ls.overhead_summary()["overlap_efficiency"] == 0.0


# ---------------------------------------------------------------------------
# store flush error context
# ---------------------------------------------------------------------------

def test_store_flush_chains_failed_job_context(tmp_path):
    params = {"w": torch.arange(24.0).reshape(8, 3)}
    part = partition_pytree(params, block_rows=4)
    rec = Recorder()
    store = ShardedCheckpointStore(str(tmp_path), device="cpu")
    store.attach_recorder(rec)
    store._retry_base_delay = 1e-4
    store.init(params, part)

    def boom(jobs, step):
        raise OSError("disk full")

    store._do_write = boom
    store.write_blocks(np.ones((part.total_blocks,), bool), params, step=7,
                       background=True)
    with pytest.raises(RuntimeError) as ei:
        store.flush()
    msg = str(ei.value)
    assert "step 7" in msg and "segment" in msg and "shard" in msg
    # flush's context -> the retry budget's RuntimeError -> the OSError
    assert isinstance(ei.value.__cause__, RuntimeError)
    assert "attempts" in str(ei.value.__cause__)
    assert isinstance(ei.value.__cause__.__cause__, OSError)
    ev = [e for e in rec.events if e["kind"] == "store_write_failed"]
    assert len(ev) == 1
    assert ev[0]["step"] == 7 and "disk full" in ev[0]["error"]
    assert ev[0]["segment"] is not None and ev[0]["path"] is not None
    retried = [e for e in rec.events if e["kind"] == "store_write_retried"]
    assert len(retried) == store._retry_limit
    store.flush()   # the error is one-shot
