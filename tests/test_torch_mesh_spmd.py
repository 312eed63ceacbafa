"""The sharded arena and the elastic mesh over several ranks: gloo ranks in
subprocesses (one torch thread each, a ``file://`` rendezvous in the
test's directory), reduced qwen2-1.5b in f32, the reference's stacked
partition.

- a 1-rank mesh is the port's loop without a mesh, bit for bit (losses,
  the running-checkpoint arena, the final parameters);
- on one 4-rank (2, 2) mesh the arena and PyTree loops are bit-equal
  through a host loss at step 3 that the replicas restore (losses, every
  rank's checkpoint span, every rank's parameter span, the recovery's
  report), the arena loop never packs and ships the replica across hosts;
  a meshed fabric without the arena pipeline raises ``ValueError``;
- two hosts of a 4-host, 4-rank mesh lost together: the recovery at the
  first rank restores blocks from PEER_REPLICA, PARITY (the parity rows
  gathered from their owners) and RUNNING_CKPT, the live tiers at zero
  perturbation, every rank with the same report and losses;
- the reference's elastic schedule on 8 ranks
  (``tests/test_sharded_arena.py::test_spmd_elastic_shrink_heal_regrow``):
  a host loss at step 4 shrinks the (4, 2) mesh to 4 shards (6 devices
  alive, the batch of 8 split over 4), the heal at step 9 re-grows it to
  8, ``mesh_resizes`` 2, ``live_packs`` 0, every rank's losses the same,
  and the losses within rtol 1e-5 of the reference's single-device run on
  the same initial parameters and batches (float32 sums in another order:
  the mean of the ranks' mean gradients, reduced by gloo).

Every rank's join has a deadline: a hung collective fails its test.
"""
import json
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.configs import get_config as j_get_config
from repro.core.policy import CheckpointPolicy as JPolicy
from repro.data.pipeline import ShardedLMDataset as JDataset
from repro.fabric import FabricConfig as JFabric
from repro.sharding import single_device_ctx
from repro.training import TrainLoop as JLoop
from repro.training import TrainLoopConfig as JLoopConfig

SRC = Path(__file__).resolve().parents[1] / "src"
DEADLINE = 150

DRIVER = r'''
import datetime, json, pickle, sys
import torch
import torch.distributed as dist

torch.set_num_threads(1)
rank, world, rdv, job, out = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], sys.argv[4], sys.argv[5])
dist.init_process_group("gloo", init_method=f"file://{rdv}", rank=rank,
                        world_size=world,
                        timeout=datetime.timedelta(seconds=120))
from repro_torch.configs import get_config
from repro_torch.core.arena import pack_arena
from repro_torch.core.blocks import partition_pytree
from repro_torch.core.policy import CheckpointPolicy
from repro_torch.data import ShardedLMDataset
from repro_torch.distributed import collectives
from repro_torch.fabric import CheckpointFabric, FabricConfig
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.sharding.partition import make_dist_ctx
from repro_torch.training import TrainLoop, TrainLoopConfig

# pieces of 64 KB: the arena-sized collectives run in several rounds here
collectives.CHUNK_BYTES = 1 << 16
cfg = get_config("qwen2-1.5b", reduced=True)
ctx = make_dist_ctx(make_host_mesh(model=2 if world > 1 else 1))
res = {"rank": rank}


def loop(fabric, arena=True, ctx=ctx, **kw):
    return TrainLoop(cfg, loop_cfg=TrainLoopConfig(
        policy=CheckpointPolicy.scar(fraction=0.25, interval=2),
        fabric=fabric, arena_state=arena, per_layer_leaves=False, **kw),
        device="cpu", ctx=ctx)


def run(lp, params, steps, batch, ctx=ctx):
    state = lp.init_state(params=params)
    ds = ShardedLMDataset(cfg, batch, 32, device="cpu", ctx=ctx)
    return lp.run(state, iter(ds), steps)


params = pickle.load(open(f"{out}/params.pkl", "rb"))
if job == "one":
    fab = FabricConfig(n_devices=1, devices_per_host=1)
    lm = loop(fab)
    sm = run(lm, params, 4, 4)
    ln = loop(fab, ctx=None)
    sn = run(ln, params, 4, 4, ctx=None)
    res["losses"] = [[m["loss"] for m in lm.metrics],
                     [m["loss"] for m in ln.metrics]]
    res["ckpt_equal"] = bool(torch.equal(lm.controller._ckpt_arena,
                                         ln.controller._ckpt_arena))
    res["arena_equal"] = bool(torch.equal(sm.arena, sn.arena))
    res["saves"] = lm.controller.stats["saves"]
elif job == "eq":
    # host 0 lost at step 3 (no resize): both paths recover through it
    fab = FabricConfig(n_devices=world, devices_per_host=2)
    la = loop(fab, fail_schedule=[(3, "host", 0)])
    sa = run(la, params, 4, 8)
    lt = loop(fab, arena=False, fail_schedule=[(3, "host", 0)])
    st = run(lt, params, 4, 8)
    w0, w1 = sa.layout.span(ctx.mesh.position())
    res["losses"] = [[m["loss"] for m in la.metrics],
                     [m["loss"] for m in lt.metrics]]
    res["failures"] = [[f for m in lp.metrics for f in m.get("failures", [])]
                       for lp in (la, lt)]
    res["state"] = type(sa).__name__
    res["ckpt_equal"] = bool(torch.equal(la.controller._ckpt_arena,
                                         lt.controller._ckpt_arena))
    res["arena_equal"] = bool(torch.equal(
        sa.arena, pack_arena(st.params, sa.layout)[w0:w1]))
    fa = la.controller.fabric
    res["stats"] = {k: fa.stats[k] for k in (
        "live_packs", "arena_resident_maintains", "arena_maintains",
        "ici_bytes_moved", "dcn_bytes_moved")}
    res["shift"] = fa._shift
    res["saves"] = la.controller.stats["saves"]
    try:
        CheckpointFabric(partition_pytree({"w": torch.zeros(64, 8)}, 8),
                         FabricConfig(n_devices=world, fused=False),
                         mesh=ctx.mesh)
    except ValueError as e:
        res["gate"] = str(e)
elif job == "parity":
    lp = loop(FabricConfig(n_devices=world, devices_per_host=1),
              fail_schedule=[(3, "host", 0), (3, "host", 2)])
    st = run(lp, params, 4, 8)
    res["losses"] = [m["loss"] for m in lp.metrics]
    res["failures"] = [f for m in lp.metrics for f in m.get("failures", [])]
    res["finite"] = bool(torch.isfinite(st.arena.view(torch.float32)).all())
elif job == "elastic":
    lp = loop(FabricConfig(elastic=True), fail_schedule=[(4, "host", 1)],
              heal_after=5)
    st = run(lp, params, 12, 8)
    fab = lp.controller.fabric
    res["losses"] = [m["loss"] for m in lp.metrics]
    res["resizes"] = [[m["step"], m["mesh_resize"]] for m in lp.metrics
                      if "mesh_resize" in m]
    res["idle"] = [m["step"] for m in lp.metrics if m.get("idle")]
    res["stats"] = {k: fab.stats[k] for k in ("mesh_resizes", "live_packs")}
    res["alive"] = int(fab.view.n_alive_devices)
    res["shards"] = [lp.arena_layout.shards, fab.arena_layout.shards,
                     st.layout.shards]
    res["state"] = type(st).__name__
    res["finite"] = bool(torch.isfinite(st.arena.view(torch.float32)).all())
json.dump(res, open(f"{out}/{job}_{rank}.json", "w"))
dist.destroy_process_group()
'''


def _ranks(tmp_path: Path, job: str, world: int, params) -> list:
    """Run ``job`` on ``world`` gloo ranks; their reports, in rank order.
    Fails when a rank fails or the ranks outlive ``DEADLINE`` seconds."""
    (tmp_path / "rank.py").write_text(DRIVER)
    with open(tmp_path / "params.pkl", "wb") as f:
        pickle.dump(params, f)
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1",
               GLOO_SOCKET_IFNAME="lo")
    rdv = tmp_path / f"rdv_{job}"
    procs = [subprocess.Popen(
        [sys.executable, str(tmp_path / "rank.py"), str(r), str(world),
         str(rdv), job, str(tmp_path)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    end = time.monotonic() + DEADLINE
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(1.0, end - time.monotonic()))
            logs.append(out)
    except subprocess.TimeoutExpired:
        pytest.fail(f"{job}: the ranks did not finish in {DEADLINE} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"{job} rank {r} failed:\n{log[-4000:]}"
    return [json.loads((tmp_path / f"{job}_{r}.json").read_text())
            for r in range(world)]


def _reference_params(seed: int = 0):
    jcfg = j_get_config("qwen2-1.5b", reduced=True)
    from repro.models import get_model
    params = get_model(jcfg).init_params(jax.random.PRNGKey(seed), jcfg)
    return jax.tree_util.tree_map(np.asarray, params)


def test_one_rank_mesh_is_the_loop_without_a_mesh(tmp_path):
    r, = _ranks(tmp_path, "one", 1, _reference_params())
    assert r["losses"][0] == r["losses"][1]
    assert r["ckpt_equal"] and r["arena_equal"] and r["saves"] >= 2


def test_four_rank_arena_and_pytree_loops_bit_equal(tmp_path):
    ranks = _ranks(tmp_path, "eq", 4, _reference_params())
    for r in ranks:
        assert r["state"] == "ArenaTrainState"
        assert r["losses"][0] == r["losses"][1] == ranks[0]["losses"][0]
        assert all(np.isfinite(r["losses"][0]))
        assert r["ckpt_equal"] and r["arena_equal"] and r["saves"] >= 2
        fa, ft = r["failures"]
        assert fa == ft == ranks[0]["failures"][0] and len(fa) == 1
        assert fa[0]["tier_counts"]["PEER_REPLICA"] == fa[0]["lost_blocks"] > 0
        s = r["stats"]
        assert s["live_packs"] == 0
        assert s["arena_resident_maintains"] == s["arena_maintains"] == 4
        # the replica is shipped to another host: a real rotation
        assert r["shift"] != 0 and s["dcn_bytes_moved"] > 0
        assert "arena" in r["gate"].lower()


def test_two_host_loss_recovers_through_the_parity(tmp_path):
    ranks = _ranks(tmp_path, "parity", 4, _reference_params())
    f, = ranks[0]["failures"]
    tiers = f["tier_counts"]
    assert tiers["PARITY"] > 0 and tiers["PEER_REPLICA"] > 0
    assert sum(n for t, n in tiers.items() if t != "SURVIVOR") \
        == f["lost_blocks"] > 0
    assert f["tier_sq"]["PARITY"] == f["tier_sq"]["PEER_REPLICA"] == 0.0
    for r in ranks:
        assert r["failures"] == ranks[0]["failures"]
        assert r["losses"] == ranks[0]["losses"] and r["finite"]
        assert all(np.isfinite(r["losses"]))


def test_elastic_shrink_heal_regrow_against_reference(tmp_path):
    jcfg = j_get_config("qwen2-1.5b", reduced=True)
    ctx = single_device_ctx()
    jl = JLoop(jcfg, ctx, loop_cfg=JLoopConfig(
        policy=JPolicy.scar(fraction=0.25, interval=2),
        fabric=JFabric(elastic=True), fail_schedule=[(4, "host", 1)],
        heal_after=5))
    js = jl.init_state()
    params = jax.tree_util.tree_map(np.asarray, js.params)
    jl.run(js, iter(JDataset(jcfg, 8, 32, ctx)), 12)
    want = [m["loss"] for m in jl.metrics]
    ranks = _ranks(tmp_path, "elastic", 8, params)
    for r in ranks:
        # 6 alive after the host loss; the batch of 8 splits over 4
        assert [x[1]["shards"] for x in r["resizes"]] == [4, 8]
        assert [x[0] for x in r["resizes"]] == [4, 9]
        assert r["stats"] == {"mesh_resizes": 2, "live_packs": 0}
        assert r["alive"] == 8 and r["shards"] == [8, 8, 8]
        assert r["state"] == "ArenaTrainState" and r["finite"]
        assert r["losses"] == ranks[0]["losses"]
    # ranks 2, 3 (the lost host) and 6, 7 (past the 4 survivors) sat out
    # steps 5-9
    assert [r["idle"] for r in ranks] == [[], [], *[[5, 6, 7, 8, 9]] * 2,
                                          [], [], *[[5, 6, 7, 8, 9]] * 2]
    np.testing.assert_allclose(ranks[0]["losses"], want, rtol=1e-5)
