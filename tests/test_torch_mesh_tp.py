"""The tensor- and expert-parallel forward on a mesh against the
reference's on a forced 4-device CPU mesh.

The reference runs in one subprocess (``XLA_FLAGS`` forcing 4 CPU devices,
a ``(2, 2)`` ``("data", "model")`` mesh); the port runs on gloo ranks in
subprocesses (one torch thread each, a ``file://`` rendezvous in the
test's directory). The reference draws every input (parameters,
activations, batches) and hands them over as numpy. Reduced qwen3-moe
(every layer MoE, top-2 of 4 experts) and reduced llama4-maverick (a dense
and an MoE layer, top-1, a shared expert), f32:

- ``lm_logits`` on the mesh: the ranks' vocab blocks all-gathered are the
  whole head's logits;
- ``moe_block`` on the mesh, with and without ``moe_reduce_scatter``: each
  rank's output is the reference's rows of its data shard within rtol and
  atol 1e-4, the two routes the same bits, and the aux losses each data
  shard's own (the reference's per-device values of its ``P()`` outputs)
  within rtol 1e-5;
- ``jax.grad(train_loss)`` on the mesh: the port's ranks' gradients
  (each rank's slices, summed over the mesh and divided by the data
  positions) within a relative L2 of 1e-4, leaf by leaf;
- three ``TrainLoop`` steps on the mesh under ``scar(0.25, 2)`` and the
  4-device elastic fabric, arena and PyTree state: the two bit-equal and
  the same on every rank; the losses within rtol 1e-4 of the reference's
  one-device loop with ``microbatch=2`` (the mean of the data shards'
  losses, whose gradient the reference's mesh takes; its mesh loop
  reports the lm loss plus data shard 0's aux losses, the value of a
  ``P()`` output), and qwen3-moe's final parameters within a relative L2
  of 1e-4 of the reference's mesh loop's.

Under ``sgd`` (no moments) the elastic resize moves the arena alone: a
host loss shrinks the (2, 2) mesh to (2, 1) and the heal re-grows it, the
losses those of one device with 2 microbatches.

In process: a one-position mesh is the ctx-less path bit for bit,
``model_slices`` cuts the dims of ``param_partition_specs``' ``model``
entries on every reduced transformer config (stacked and per-layer
leaves), and on a ``(1, 2)`` mesh (one data position: the gradient's
divisor is 1) the trainer's losses under ``sgd`` are those of one device.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.sharding import partition as jp
from repro_torch.configs import get_config
from repro_torch.interop import from_numpy_tree
from repro_torch.models import get_model, layers
from repro_torch.models.layers import split_layers
from repro_torch.sharding import partition as tp
from repro_torch.utils.tree import flatten_with_path, keystr

SRC = Path(__file__).resolve().parents[1] / "src"
ARCHS = ("qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b")
DEADLINE = 150
B, S = 4, 32

REF = r'''
import dataclasses, pickle, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.core.policy import CheckpointPolicy
from repro.data.pipeline import ShardedLMDataset
from repro.fabric import FabricConfig
from repro.launch.mesh import make_mesh_compat
from repro.models import get_model, layers
from repro.sharding.partition import make_dist_ctx, single_device_ctx
from repro.training import TrainLoop, TrainLoopConfig

out = sys.argv[1]
mesh = make_mesh_compat((2, 2), ("data", "model"))
ctx = make_dist_ctx(mesh)
np_ = lambda t: jax.tree_util.tree_map(np.asarray, t)
res = {}


def per_device(a):
    return [float(np.asarray(s.data)) for s in
            sorted(a.addressable_shards, key=lambda s: s.device.id)]


def loop(cfg, c, arena=True, n=4, elastic=True):
    return TrainLoop(cfg, c, loop_cfg=TrainLoopConfig(
        policy=CheckpointPolicy.scar(fraction=0.25, interval=2),
        fabric=FabricConfig(n_devices=n, devices_per_host=2 if n > 1 else 1,
                            elastic=elastic), arena_state=arena))


for k, name in enumerate(%(archs)r):
    cfg = get_config(name, reduced=True)
    ops = get_model(cfg)
    params = ops.init_params(jax.random.PRNGKey(k), cfg)
    r = {"params": np_(params)}
    lay = params["layers"]
    moe = jax.tree_util.tree_map(lambda t: t[0], lay["moe"] if "dense" in lay
                                 else lay)["moe"]
    x = jax.random.normal(jax.random.PRNGKey(100 + k), (%(B)d, %(S)d,
                                                       cfg.d_model))
    xs = jax.device_put(x, NamedSharding(mesh, P("data", None, None)))
    r["moe_params"], r["x"] = np_(moe), np.asarray(x)
    for rs in (False, True):
        c2 = dataclasses.replace(cfg, moe_reduce_scatter=rs)
        o, (lb, zl) = jax.jit(lambda a, p: layers.moe_block(a, p, c2, ctx))(
            xs, moe)
        r[f"moe_{int(rs)}"] = (np.asarray(o), per_device(lb), per_device(zl))
    ds = ShardedLMDataset(cfg, %(B)d, %(S)d, ctx)
    batch = ds.next_batch()
    r["batch"] = np_(batch)
    g = jax.jit(jax.grad(lambda p, b: ops.train_loss(p, b, cfg, ctx)))(
        params, batch)
    r["grads"] = np_(g)
    # the trainers: the one-device loop with 2 microbatches (the mean of
    # the data shards' losses) and, for the first config, the mesh loop
    one = loop(dataclasses.replace(cfg, microbatch=2), single_device_ctx(),
               n=1, elastic=False)
    st = one.init_state()
    r["loop_params"] = np_(st.params)
    one.run(st, iter(ShardedLMDataset(cfg, %(B)d, %(S)d,
                                      single_device_ctx())), 3)
    r["mb2_losses"] = [m["loss"] for m in one.metrics]
    if k == 0:
        lm = loop(cfg, ctx)
        sm = lm.run(lm.init_state(), iter(ShardedLMDataset(cfg, %(B)d, %(S)d,
                                                           ctx)), 3)
        r["mesh_losses"] = [m["loss"] for m in lm.metrics]
        r["mesh_final"] = np_(sm.params)
    res[name] = r
pickle.dump(res, open(f"{out}/ref.pkl", "wb"))
print("REF-OK")
''' % {"archs": ARCHS, "B": B, "S": S}

RANK = r'''
import dataclasses, datetime, pickle, sys
import numpy as np
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
from repro_torch.core.policy import CheckpointPolicy
from repro_torch.data import ShardedLMDataset
from repro_torch.data.pipeline import slice_batch
from repro_torch.distributed import collectives
from repro_torch.fabric import FabricConfig
from repro_torch.interop import from_numpy_tree, to_numpy_tree
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import get_model, layers
from repro_torch.optim import sgd
from repro_torch.sharding.partition import (make_dist_ctx, model_slices,
                                            take_model_slices)
from repro_torch.training import TrainLoop, TrainLoopConfig
from repro_torch.training.step import loss_and_grad
from repro_torch.utils.tree import tree_flatten

collectives.CHUNK_BYTES = 1 << 16
mesh = make_host_mesh(model=2)
ctx = make_dist_ctx(mesh)
res = {"rank": rank, "coords": list(mesh.coords())}


def drawn(cfg):
    """The port's own draw (the jobs that hold the mesh to one device)."""
    return to_numpy_tree(get_model(cfg).init_params(
        torch.Generator().manual_seed(7), cfg, device="cpu"))


def loop(cfg, c, arena=True, n=4, opt=None):
    return TrainLoop(cfg, opt, TrainLoopConfig(
        policy=CheckpointPolicy.scar(fraction=0.25, interval=2),
        fabric=FabricConfig(n_devices=n, devices_per_host=2 if n > 1 else 1,
                            elastic=n > 1), arena_state=arena,
        per_layer_leaves=False), device="cpu", ctx=c)


def dump(t):
    return [np.asarray(x) for x in tree_flatten(to_numpy_tree(t))[0]]


if job == "tp":
    ref = pickle.load(open(f"{out}/ref.pkl", "rb"))
    d = mesh.axis_position("data")
    for name, r in ref.items():
        cfg = get_config(name, reduced=True)
        out_r = {}
        p = from_numpy_tree(r["moe_params"], "cpu")
        p = take_model_slices(p, model_slices(p, ctx))
        x = torch.from_numpy(r["x"][d * 2:(d + 1) * 2].copy())
        for rs in (0, 1):
            c2 = dataclasses.replace(cfg, moe_reduce_scatter=bool(rs))
            collectives.reset_stats()
            o, (lb, zl) = layers.moe_block(x, p, c2, ctx)
            out_r[f"moe_{rs}"] = (o.numpy(), float(lb), float(zl))
            out_r[f"stats_{rs}"] = sorted(collectives.STATS)
        ops = get_model(cfg)
        params = from_numpy_tree(r["params"], "cpu")
        h = torch.from_numpy(r["x"][d * 2:(d + 1) * 2].copy())
        got = layers.lm_logits(h, take_model_slices(
            params, model_slices(params, ctx)), ctx)
        want = layers.lm_logits(h, params)
        out_r["logits"] = (float((got - want).abs().max()),
                           float(want.abs().max()), tuple(got.shape))
        b = slice_batch(r["batch"], mesh, "cpu", True)
        loss, g = loss_and_grad(ops, cfg, params, dict(b), ctx)
        leaves = tree_flatten(g)[0]
        for x in leaves:
            dist.all_reduce(x)
        out_r["loss"] = float(loss)
        if rank == 0:
            out_r["grads"] = [x.numpy() / 2 for x in leaves]
        res[name] = out_r
        lp = {}
        for arena in (True, False):
            lo = loop(cfg, ctx, arena)
            st = lo.run(lo.init_state(params=r["loop_params"]),
                        iter(ShardedLMDataset(cfg, 4, 32, device="cpu",
                                              ctx=ctx)), 3)
            lp[arena] = {"losses": [m["loss"] for m in lo.metrics],
                         "state": type(st).__name__}
            if arena:
                w0, w1 = st.layout.span(mesh.position())
                lp["layout"] = st.layout
                lp["span"] = st.arena.clone()
            else:
                lp["tree_span"] = pack_arena(st.params, lp["layout"])[w0:w1]
                if rank == 0:
                    lp["final"] = dump(st.params)
        res[name]["loops"] = {
            "arena": lp[True], "pytree": lp[False],
            "spans_equal": bool(torch.equal(lp["span"], lp["tree_span"])),
            "final": lp.get("final")}
elif job == "shrink":
    # sgd (no moments) through a host loss that shrinks (2, 2) to (2, 1)
    # and a heal that re-grows it
    cfg = get_config("qwen3-moe-235b-a22b", reduced=True)
    params = drawn(cfg)

    def run(cfg_, ctx_):
        lo = TrainLoop(cfg_, sgd(0.5), TrainLoopConfig(
            policy=CheckpointPolicy.scar(fraction=0.25, interval=2),
            fabric=FabricConfig(n_devices=4, devices_per_host=2,
                                elastic=True),
            fail_schedule=[(2, "host", 1)], heal_after=2,
            per_layer_leaves=False), device="cpu", ctx=ctx_)
        lo.run(lo.init_state(params=params),
               iter(ShardedLMDataset(cfg, 4, 32, device="cpu", ctx=ctx_)),
               5)
        return lo
    lo = run(cfg, ctx)
    res["losses"] = [m["loss"] for m in lo.metrics]
    res["shards"] = [m["mesh_resize"]["shards"] for m in lo.metrics
                     if "mesh_resize" in m]
    if rank == 0:
        one = run(dataclasses.replace(cfg, microbatch=2), None)
        res["one_losses"] = [m["loss"] for m in one.metrics]
elif job == "one2":
    # (1, 2): one data position, so the gradient's divisor is 1
    cfg = get_config("qwen3-moe-235b-a22b", reduced=True)
    params = drawn(cfg)
    lo = loop(cfg, ctx, n=2, opt=sgd(0.5))
    st = lo.run(lo.init_state(params=params),
                iter(ShardedLMDataset(cfg, 2, 32, device="cpu", ctx=ctx)), 3)
    res["losses"] = [m["loss"] for m in lo.metrics]
    if rank == 0:
        # the same on one device, in this process (no mesh)
        l1 = TrainLoop(cfg, sgd(0.5), TrainLoopConfig(
            policy=CheckpointPolicy.scar(fraction=0.25, interval=2),
            fabric=FabricConfig(n_devices=1, devices_per_host=1),
            per_layer_leaves=False), device="cpu")
        l1.run(l1.init_state(params=params),
               iter(ShardedLMDataset(cfg, 2, 32, device="cpu")), 3)
        res["one_losses"] = [m["loss"] for m in l1.metrics]
pickle.dump(res, open(f"{out}/{job}_{rank}.pkl", "wb"))
dist.destroy_process_group()
'''


def _reference(out: Path) -> dict:
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.run([sys.executable, "-c", REF, str(out)],
                          capture_output=True, text=True, timeout=300,
                          env=env)
    assert proc.returncode == 0 and "REF-OK" in proc.stdout, (
        f"the reference's subprocess failed:\n{proc.stderr[-4000:]}")
    return pickle.load(open(out / "ref.pkl", "rb"))


def _ranks(out: Path, job: str, world: int) -> list:
    """Run ``job`` on ``world`` gloo ranks; their reports in rank order.
    Fails when a rank fails or the ranks outlive ``DEADLINE`` seconds."""
    (out / "rank.py").write_text(RANK)
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1",
               GLOO_SOCKET_IFNAME="lo")
    rdv = out / f"rdv_{job}"
    procs = [subprocess.Popen(
        [sys.executable, str(out / "rank.py"), str(r), str(world), str(rdv),
         job, str(out)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    end = time.monotonic() + DEADLINE
    logs = []
    try:
        for p in procs:
            o, _ = p.communicate(timeout=max(1.0, end - time.monotonic()))
            logs.append(o)
    except subprocess.TimeoutExpired:
        pytest.fail(f"{job}: the ranks did not finish in {DEADLINE} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"{job} rank {r} failed:\n{log[-4000:]}"
    return [pickle.load(open(out / f"{job}_{r}.pkl", "rb"))
            for r in range(world)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's run, then the port's ranks on its draws (``tp``);
    the jobs that hold the mesh to the port's own one-device run (``one2``,
    ``shrink``) run beside the reference."""
    out = tmp_path_factory.mktemp("mesh_tp")
    with ThreadPoolExecutor(2) as pool:
        ref = pool.submit(_reference, out)
        own = pool.submit(lambda: (_ranks(out, "one2", 2),
                                   _ranks(out, "shrink", 4)))
        ref, own = ref.result(), own.result()
    return (ref, _ranks(out, "tp", 4)) + own


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("rs", (0, 1))
def test_moe_block_matches_reference(runs, name, rs):
    ref, ranks = runs[:2]
    want, lbs, zls = ref[name][f"moe_{rs}"]
    for r in ranks:
        d = r["coords"][0]
        got, lb, zl = r[name][f"moe_{rs}"]
        np.testing.assert_allclose(got, want[d * 2:(d + 1) * 2], rtol=1e-4,
                                   atol=1e-4)
        # the reduce-scatter route gives the all-reduce's bits
        np.testing.assert_array_equal(got, r[name]["moe_0"][0])
        # the data shard's own aux losses: the reference's devices 2 d and
        # 2 d + 1 hold them
        np.testing.assert_allclose([lb, zl], [lbs[2 * d], zls[2 * d]],
                                   rtol=1e-5)
        route = {"moe_reduce_scatter", "moe_all_gather"}
        assert route <= set(r[name]["stats_1"])
        assert not route & set(r[name]["stats_0"])
        assert "reduce_from_model" in r[name]["stats_0"]
    # the two data shards' aux losses differ: each shard has its own
    assert lbs[0] != lbs[2]


@pytest.mark.parametrize("name", ARCHS)
def test_mesh_gradient_matches_reference(runs, name):
    ref, ranks = runs[:2]
    jg = [x for _, x in flatten_with_path(ref[name]["grads"])[0]]
    got = ranks[0][name]["grads"]
    assert len(got) == len(jg)
    for g, w in zip(got, jg):
        assert _rel_l2(g, w) <= 1e-4
    # every rank of a data shard's model line has the shard's loss
    assert ranks[0][name]["loss"] == ranks[1][name]["loss"]
    assert ranks[2][name]["loss"] == ranks[3][name]["loss"]


@pytest.mark.parametrize("name", ARCHS)
def test_vocab_parallel_logits_are_the_whole_vocab(runs, name):
    """``lm_logits`` on a model axis: each rank's block of the vocab,
    all-gathered, is the whole head's logits."""
    ref, ranks = runs[:2]
    V = ref[name]["params"]["lm_head"].shape[0]
    for r in ranks:
        err, scale, shape = r[name]["logits"]
        assert shape[-1] == V and err <= 1e-5 * scale


@pytest.mark.parametrize("name", ARCHS)
def test_mesh_train_loop_matches_reference(runs, name):
    ref, ranks = runs[:2]
    want = ref[name]["mb2_losses"]
    for r in ranks:
        lp = r[name]["loops"]
        assert lp["arena"]["state"] == "ArenaTrainState"
        assert lp["arena"]["losses"] == lp["pytree"]["losses"] \
            == ranks[0][name]["loops"]["arena"]["losses"]
        assert lp["spans_equal"]
        np.testing.assert_allclose(lp["arena"]["losses"], want, rtol=1e-4)
    if "mesh_final" in ref[name]:
        jf = [x for _, x in flatten_with_path(ref[name]["mesh_final"])[0]]
        got = ranks[0][name]["loops"]["final"]
        init = [x for _, x in flatten_with_path(
            ref[name]["loop_params"])[0]]
        for g, w, x0 in zip(got, jf, init):
            assert _rel_l2(g, w) <= 1e-4
        # the loops moved the parameters
        assert any(not np.array_equal(w, x0) for w, x0 in zip(jf, init))


def test_sgd_mesh_shrinks_and_regrows(runs):
    """sgd keeps no moments: the elastic resize moves the arena alone.
    Host 1 lost at step 2 shrinks (2, 2) to (2, 1), the heal re-grows it;
    the losses are one device's with 2 microbatches."""
    ranks = runs[3]
    for r in ranks:
        assert r["shards"] == [2, 4]
        assert r["losses"] == ranks[0]["losses"]
    np.testing.assert_allclose(ranks[0]["losses"], ranks[0]["one_losses"],
                               rtol=1e-5)


def test_one_by_two_mesh_is_one_device(runs):
    """One data position and two model positions: the mesh's sgd steps
    are one device's (a divisor of the model positions would halve every
    step after the first)."""
    ranks = runs[2]
    assert ranks[0]["losses"] == ranks[1]["losses"]
    np.testing.assert_allclose(ranks[0]["losses"], ranks[0]["one_losses"],
                               rtol=1e-5)
    assert ranks[0]["one_losses"][0] != ranks[0]["one_losses"][-1]


# ---------------------------------------------------------------------------
# in process
# ---------------------------------------------------------------------------

class _StandIn:
    """A mesh shape for the specs (they read axis names and sizes only)."""

    def __init__(self, shape, axes):
        self.shape = dict(zip(axes, shape))
        self.axis_names = tuple(axes)
        self.devices = np.arange(int(np.prod(shape))).reshape(shape)


def _params(name):
    cfg = get_config(name, reduced=True)
    return cfg, get_model(cfg).init_params(
        torch.Generator().manual_seed(0), cfg, device="cpu")


@pytest.mark.parametrize("name", ("qwen2-1.5b", "internvl2-76b") + ARCHS)
def test_model_slices_follow_param_specs(name):
    """Each leaf's cut is its spec's ``model`` entry (the router and the
    VLM projector computed whole, the biases on their heads); the
    per-layer leaves take the same rows and columns."""
    cfg, params = _params(name)
    ctx = tp.DistContext(mesh=_StandIn((2, 2), ("data", "model")))
    specs = tp.param_partition_specs(params, ctx)
    jspecs = jp.param_partition_specs(params, jp.DistContext(
        mesh=_StandIn((2, 2), ("data", "model"))))
    for pos in (0, 1):
        sl = tp.model_slices(params, ctx, pos)
        flat_sl = dict((keystr(p), s) for p, s in flatten_with_path(sl)[0])
        n_cut = 0
        for (path, leaf), (_, spec), (_, jspec) in zip(
                flatten_with_path(params)[0], flatten_with_path(specs)[0],
                flatten_with_path(jspecs)[0]):
            k = keystr(path)
            assert tuple(spec) == tuple(jspec), k
            s = flat_sl[k]
            key = tp._key(k)
            if key in ("router", "proj"):
                assert not s and "model" in spec, k
                continue
            if key in ("bq", "bk", "bv"):
                assert s[0] == leaf.dim() - 2, k
            elif "model" in spec:
                assert s and s[0] == list(spec).index("model"), k
            else:
                assert not s, k
            if s:
                n = leaf.shape[s[0]] // 2
                assert (s[1], s[2]) == (pos * n, (pos + 1) * n), k
                n_cut += 1
        assert n_cut >= 8
        # the per-layer layout: the same values cut
        split = split_layers(params, get_model(cfg).stacked_layers)
        whole = tp.take_model_slices(params, sl)
        cut = tp.take_model_slices(split, tp.model_slices(split, ctx, pos))
        for lp_w, lp_c in zip(layers.unstack_layers(
                whole["layers"], len(cut["layers"])), cut["layers"]):
            for (p1, a), (p2, b) in zip(flatten_with_path(lp_w)[0],
                                        flatten_with_path(lp_c)[0]):
                assert torch.equal(a.reshape(b.shape), b), keystr(p1)


def test_tensor_parallel_needs_every_dim_to_split():
    # query heads split into whole-head ranges (3 over 1 kv head at 2:
    # [0, 2) and [2, 3)), unless a range crosses kv groups unevenly (10
    # over 5 at 2: [0, 5) reads kv head 2 in part)
    cfg = dataclasses.replace(get_config("qwen2-1.5b", reduced=True),
                              n_kv_heads=1, n_heads=3)
    tp.check_tensor_parallel(cfg, 2)
    cfg = dataclasses.replace(cfg, n_kv_heads=5, n_heads=10)
    with pytest.raises(ValueError, match="qwen2-1.5b.*n_heads"):
        tp.check_tensor_parallel(cfg, 2)
    tp.check_tensor_parallel(get_config("qwen3-moe-235b-a22b"), 2)
    # a vocab that does not split is computed whole (whisper-medium's
    # 51,865); the SSD heads must split
    for n in (2, 4):
        tp.check_tensor_parallel(get_config("whisper-medium"), n)
    ssm = dataclasses.replace(get_config("mamba2-370m", reduced=True),
                              ssm_headdim=512)          # 1 SSD head
    with pytest.raises(ValueError, match="mamba2-370m.*ssm_heads"):
        tp.check_tensor_parallel(ssm, 2)


@pytest.mark.parametrize("name", ARCHS + ("qwen2-1.5b",))
def test_one_position_mesh_is_the_ctx_less_path(name):
    """A ``(1, 1)`` mesh (no process group): ``train_loss``, its gradient
    and ``moe_block`` are the ctx-less calls bit for bit."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.training.step import loss_and_grad
    cfg, params = _params(name)
    ctx = tp.make_dist_ctx(make_host_mesh())
    rng = np.random.default_rng(3)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 17)).astype(
        np.int32))
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    ops = get_model(cfg)
    l0, g0 = loss_and_grad(ops, cfg, params, batch)
    l1, g1 = loss_and_grad(ops, cfg, params, batch, ctx)
    assert torch.equal(l0, l1)
    for a, b in zip(flatten_with_path(g0)[0], flatten_with_path(g1)[0]):
        assert torch.equal(a[1], b[1]), keystr(a[0])
    if cfg.n_experts:
        lay = params["layers"]
        moe = layers.layer_params({"layers": lay["moe"] if "dense" in lay
                                   else lay}, 0)["moe"]
        x = torch.from_numpy(rng.normal(size=(2, 8, cfg.d_model)).astype(
            np.float32))
        o0, a0 = layers.moe_block(x, moe, cfg)
        o1, a1 = layers.moe_block(x, moe, cfg, ctx)
        assert torch.equal(o0, o1)
        assert all(torch.equal(a, b) for a, b in zip(a0, a1))


@pytest.mark.parametrize("name", ARCHS)
def test_numpy_tree_placed_as_model_slices(name):
    """``from_numpy_tree`` with a rank's ``model_slices`` places exactly
    the slices ``take_model_slices`` cuts from the whole tree."""
    from repro_torch.interop import to_numpy_tree
    cfg, params = _params(name)
    ctx = tp.DistContext(mesh=_StandIn((2, 2), ("data", "model")))
    arrays = to_numpy_tree(params)
    for pos in (0, 1):
        sl = tp.model_slices(arrays, ctx, pos)
        placed = from_numpy_tree(arrays, "cpu", sl)
        want = tp.take_model_slices(params, sl)
        for (path, a), (_, b) in zip(flatten_with_path(placed)[0],
                                     flatten_with_path(want)[0]):
            assert a.is_contiguous() and torch.equal(a, b), keystr(path)
