"""Tensor parallelism for the ssm, hybrid and encoder-decoder families on a
mesh, against the reference on a forced 4-device CPU mesh.

The reference runs in one subprocess (``XLA_FLAGS`` forcing 4 CPU devices,
a ``(2, 2)`` ``("data", "model")`` mesh) and draws every input; the port
runs on gloo ranks in subprocesses (one torch thread each, a ``file://``
rendezvous in the test's directory). Reduced mamba2-370m, zamba2-1.2b and
whisper-medium, f32, and whisper with an odd vocab (1,021: it splits over
no model axis, so the embedding, the head and the loss run whole on every
rank):

- ``ssm.mixer_fwd`` on the mesh (the two Mamba2 families): each rank's
  output, computed over its SSD heads and summed over the model line, is
  the reference's rows of its data shard within rtol 1e-5 and an atol of
  1e-5 of the output's largest magnitude;
- ``jax.grad(train_loss)`` on the mesh: the port's ranks' gradients
  (each rank's slices, summed over the mesh and divided by the data
  positions) within a relative L2 of 1e-4, leaf by leaf; ``in_proj``'s
  B and C columns, which every rank of a model line holds and whose
  gradient is the sum of the ranks' parts, held on their own;
- three ``TrainLoop`` steps under ``scar(0.25, 2)`` and the 4-device
  elastic fabric, arena and PyTree state: the two bit-equal and the same
  on every rank, the losses within rtol 1e-4 of the reference's own mesh
  loop (these families have no aux losses, so its loss is the mean of
  the data shards') and the final parameters within a relative L2 of
  1e-4 of its.

Under ``sgd`` a host loss shrinks the (2, 2) mesh to (2, 1) (one model
position: the whole forward on every rank) and the heal re-grows it; the
losses are one device's with 2 microbatches.

In process: ``model_slices`` gives each SSD head's z, x and dt columns of
``in_proj``, its conv channels, its ``A_log``, ``dt_bias`` and ``D_skip``
entries and its ``out_proj`` rows to exactly one model position and the
B and C columns to every one, in the stacked and the per-layer layouts;
the hybrid's unstacked shared block is cut as its specs say; a
one-position mesh is the ctx-less path bit for bit; ``from_numpy_tree``
places the several ranges of a cut.
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
from repro_torch.interop import from_numpy_tree, to_numpy_tree
from repro_torch.models import get_model
from repro_torch.models.layers import split_layers, unstack_layers
from repro_torch.sharding import partition as tp
from repro_torch.utils.tree import flatten_with_path, keystr, tree_map

SRC = Path(__file__).resolve().parents[1] / "src"
ARCHS = ("mamba2-370m", "zamba2-1.2b", "whisper-medium")
ODD = "whisper-odd"     # whisper-medium with ODD_VOCAB
ODD_VOCAB = 1021
MIXERS = ARCHS[:2]
DEADLINE = 150
B, S = 4, 32

REF = r'''
import dataclasses, pickle, sys
import numpy as np
import jax
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.core.policy import CheckpointPolicy
from repro.data.pipeline import ShardedLMDataset
from repro.fabric import FabricConfig
from repro.launch.mesh import make_mesh_compat
from repro.models import get_model, ssm
from repro.sharding.partition import make_dist_ctx
from repro.training import TrainLoop, TrainLoopConfig

out = sys.argv[1]
mesh = make_mesh_compat((2, 2), ("data", "model"))
ctx = make_dist_ctx(mesh)
np_ = lambda t: jax.tree_util.tree_map(np.asarray, t)
res = {}

for k, name in enumerate(%(archs)r + (%(odd)r,)):
    cfg = get_config(name.replace("-odd", "-medium"), reduced=True)
    if name == %(odd)r:
        cfg = dataclasses.replace(cfg, vocab=%(odd_vocab)d)
    ops = get_model(cfg)
    params = ops.init_params(jax.random.PRNGKey(k), cfg)
    r = {"params": np_(params)}
    if name in %(mixers)r:
        mixer = jax.tree_util.tree_map(lambda t: t[0],
                                       params["layers"])["mixer"]
        x = jax.random.normal(jax.random.PRNGKey(100 + k),
                              (%(B)d, %(S)d, cfg.d_model))
        xs = jax.device_put(x, NamedSharding(mesh, P("data", None, None)))
        o = jax.jit(lambda a, p: ssm.mixer_fwd(a, p, cfg, ctx))(xs, mixer)
        r["mixer"], r["x"], r["mixer_out"] = np_(mixer), np.asarray(x), \
            np.asarray(o)
    batch = ShardedLMDataset(cfg, %(B)d, %(S)d, ctx).next_batch()
    r["batch"] = np_(batch)
    g = jax.jit(jax.grad(lambda p, b: ops.train_loss(p, b, cfg, ctx)))(
        params, batch)
    r["grads"] = np_(g)
    if name != %(odd)r:
        lm = TrainLoop(cfg, ctx, loop_cfg=TrainLoopConfig(
            policy=CheckpointPolicy.scar(fraction=0.25, interval=2),
            fabric=FabricConfig(n_devices=4, devices_per_host=2,
                                elastic=True), arena_state=True))
        st = lm.init_state()
        r["loop_params"] = np_(st.params)
        sm = lm.run(st, iter(ShardedLMDataset(cfg, %(B)d, %(S)d, ctx)), 3)
        r["mesh_losses"] = [m["loss"] for m in lm.metrics]
        r["mesh_final"] = np_(sm.params)
    res[name] = r
pickle.dump(res, open(f"{out}/ref.pkl", "wb"))
print("REF-OK")
''' % {"archs": ARCHS, "odd": ODD, "odd_vocab": ODD_VOCAB, "mixers": MIXERS,
       "B": B, "S": S}

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
from repro_torch.models import get_model, ssm
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


def config(name):
    cfg = get_config(name.replace("-odd", "-medium"), reduced=True)
    if name.endswith("-odd"):
        cfg = dataclasses.replace(cfg, vocab=%(odd_vocab)d)
    return cfg


def dump(t):
    return [np.asarray(x) for x in tree_flatten(to_numpy_tree(t))[0]]


if job == "tp":
    ref = pickle.load(open(f"{out}/ref.pkl", "rb"))
    d = mesh.axis_position("data")
    for name, r in ref.items():
        cfg = config(name)
        ops = get_model(cfg)
        out_r = {}
        if "mixer" in r:
            p = from_numpy_tree(r["mixer"], "cpu")
            p = take_model_slices(p, model_slices(p, ctx))
            x = torch.from_numpy(r["x"][d * 2:(d + 1) * 2].copy())
            collectives.reset_stats()
            out_r["mixer_out"] = ssm.mixer_fwd(x, p, cfg, ctx).numpy()
            out_r["mixer_stats"] = sorted(collectives.STATS)
        params = from_numpy_tree(r["params"], "cpu")
        b = slice_batch(r["batch"], mesh, "cpu", True)
        loss, g = loss_and_grad(ops, cfg, params, dict(b), ctx)
        leaves = tree_flatten(g)[0]
        for x in leaves:
            dist.all_reduce(x)
        out_r["loss"] = float(loss)
        if rank == 0:
            out_r["grads"] = [x.numpy() / 2 for x in leaves]
        res[name] = out_r
        if "loop_params" not in r:
            continue
        lp = {}
        for arena in (True, False):
            lo = TrainLoop(cfg, None, TrainLoopConfig(
                policy=CheckpointPolicy.scar(fraction=0.25, interval=2),
                fabric=FabricConfig(n_devices=4, devices_per_host=2,
                                    elastic=True), arena_state=arena,
                per_layer_leaves=False), device="cpu", ctx=ctx)
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
    for name in %(archs)r:
        cfg = config(name)
        params = to_numpy_tree(get_model(cfg).init_params(
            torch.Generator().manual_seed(7), cfg, device="cpu"))

        def run(cfg_, ctx_):
            lo = TrainLoop(cfg_, sgd(0.5), TrainLoopConfig(
                policy=CheckpointPolicy.scar(fraction=0.25, interval=2),
                fabric=FabricConfig(n_devices=4, devices_per_host=2,
                                    elastic=True),
                fail_schedule=[(2, "host", 1)], heal_after=2,
                per_layer_leaves=False), device="cpu", ctx=ctx_)
            lo.run(lo.init_state(params=params),
                   iter(ShardedLMDataset(cfg, 4, 32, device="cpu",
                                         ctx=ctx_)), 5)
            return lo
        lo = run(cfg, ctx)
        res[name] = {"losses": [m["loss"] for m in lo.metrics],
                     "shards": [m["mesh_resize"]["shards"]
                                for m in lo.metrics if "mesh_resize" in m]}
        if rank == 0:
            one = run(dataclasses.replace(cfg, microbatch=2), None)
            res[name]["one_losses"] = [m["loss"] for m in one.metrics]
pickle.dump(res, open(f"{out}/{job}_{rank}.pkl", "wb"))
dist.destroy_process_group()
''' % {"archs": ARCHS, "odd_vocab": ODD_VOCAB}


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
    """The reference's run beside the port's own ``shrink`` job, then the
    port's ranks on the reference's draws (``tp``)."""
    out = tmp_path_factory.mktemp("mesh_tp_families")
    with ThreadPoolExecutor(2) as pool:
        ref = pool.submit(_reference, out)
        shrink = pool.submit(_ranks, out, "shrink", 4)
        ref, shrink = ref.result(), shrink.result()
    return ref, _ranks(out, "tp", 4), shrink


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _config(name):
    cfg = get_config(name.replace("-odd", "-medium"), reduced=True)
    if name == ODD:
        cfg = dataclasses.replace(cfg, vocab=ODD_VOCAB)
    return cfg


@pytest.mark.parametrize("name", MIXERS)
def test_mixer_matches_reference(runs, name):
    """rtol 1e-5, atol 1e-5 of the output's largest magnitude: in f32 the
    port and the reference, each on one device or on the mesh, are all
    1.0-2.2e-5 (absolute, outputs up to about 2.6) off a float64 run of
    the same mixer, so an atol of 1e-5 alone fails on rounding."""
    ref, ranks = runs[:2]
    want = ref[name]["mixer_out"]
    for r in ranks:
        d = r["coords"][0]
        mine = want[d * 2:(d + 1) * 2]
        np.testing.assert_allclose(r[name]["mixer_out"], mine, rtol=1e-5,
                                   atol=1e-5 * np.abs(mine).max())
        assert "reduce_from_model" in r[name]["mixer_stats"]


@pytest.mark.parametrize("name", ARCHS + (ODD,))
def test_mesh_gradient_matches_reference(runs, name):
    ref, ranks = runs[:2]
    cfg = _config(name)
    flat = flatten_with_path(ref[name]["grads"])[0]
    got = ranks[0][name]["grads"]
    assert len(got) == len(flat)
    bc = slice(2 * cfg.d_inner, 2 * cfg.d_inner + 2 * cfg.ssm_state)
    for g, (path, w) in zip(got, flat):
        k = keystr(path)
        if k.endswith("['in_proj']"):
            # every rank holds the B and C columns; the gradient there is
            # the sum of the ranks' parts
            err = _rel_l2(g[..., bc], w[..., bc])
            assert err <= 1e-4, f"{k}: in_proj's B and C columns {err}"
        assert _rel_l2(g, w) <= 1e-4, k
    # every rank of a data shard's model line has the shard's loss
    assert ranks[0][name]["loss"] == ranks[1][name]["loss"]
    assert ranks[2][name]["loss"] == ranks[3][name]["loss"]


def test_odd_vocab_is_computed_whole():
    """1,021 splits over no model axis: the embedding and the head are
    whole on every rank, the other leaves cut as with a vocab that
    divides."""
    odd = _config(ODD)
    even = get_config("whisper-medium", reduced=True)
    ctx = tp.DistContext(mesh=_StandIn((2, 2), ("data", "model")))
    shapes = {n: get_model(c).init_params(torch.Generator().manual_seed(0),
                                          c, device="cpu")
              for n, c in ((ODD, odd), ("even", even))}
    for pos in (0, 1):
        s_odd = dict((keystr(p), s) for p, s in flatten_with_path(
            tp.model_slices(shapes[ODD], ctx, pos))[0])
        s_even = dict((keystr(p), s) for p, s in flatten_with_path(
            tp.model_slices(shapes["even"], ctx, pos))[0])
        for k, s in s_even.items():
            if k in ("['embed']", "['lm_head']"):
                assert s and not s_odd[k], k
            else:
                assert s == s_odd[k], k
    assert tp.vocab_ctx(odd, ctx) is None and tp.vocab_ctx(even, ctx) is ctx


@pytest.mark.parametrize("name", ARCHS)
def test_mesh_train_loop_matches_reference(runs, name):
    ref, ranks = runs[:2]
    want = ref[name]["mesh_losses"]
    for r in ranks:
        lp = r[name]["loops"]
        assert lp["arena"]["state"] == "ArenaTrainState"
        assert lp["arena"]["losses"] == lp["pytree"]["losses"] \
            == ranks[0][name]["loops"]["arena"]["losses"]
        assert lp["spans_equal"]
        np.testing.assert_allclose(lp["arena"]["losses"], want, rtol=1e-4)
    jf = [x for _, x in flatten_with_path(ref[name]["mesh_final"])[0]]
    got = ranks[0][name]["loops"]["final"]
    init = [x for _, x in flatten_with_path(ref[name]["loop_params"])[0]]
    for g, w in zip(got, jf):
        assert _rel_l2(g, w) <= 1e-4
    # the loops moved the parameters
    assert any(not np.array_equal(w, x0) for w, x0 in zip(jf, init))


@pytest.mark.parametrize("name", ARCHS)
def test_sgd_mesh_shrinks_and_regrows(runs, name):
    """Host 1 lost at step 2 shrinks (2, 2) to (2, 1), the heal re-grows
    it; the losses are one device's with 2 microbatches."""
    ranks = runs[2]
    for r in ranks:
        assert r[name]["shards"] == [2, 4]
        assert r[name]["losses"] == ranks[0][name]["losses"]
    np.testing.assert_allclose(ranks[0][name]["losses"],
                               ranks[0][name]["one_losses"], rtol=1e-5)


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
    cfg = _config(name)
    return cfg, get_model(cfg).init_params(
        torch.Generator().manual_seed(0), cfg, device="cpu")


def _owners(mixer_slices, width: int, dim_of) -> np.ndarray:
    """How many model positions hold each index of a leaf's cut dim."""
    count = np.zeros(width, np.int64)
    for s in mixer_slices:
        assert s and s[0] == dim_of
        for lo, hi in s.ranges:
            count[lo:hi] += 1
    return count


@pytest.mark.parametrize("n_model", (2, 4))
@pytest.mark.parametrize("name", MIXERS)
def test_model_slices_cut_the_mixer_by_heads(name, n_model):
    """Each SSD head's z, x and dt columns, conv channels, scalars and
    ``out_proj`` rows go to exactly one model position, in head order; the
    B and C columns to every position; the per-layer layout takes the same
    values."""
    cfg, params = _params(name)
    DI, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    ctx = tp.DistContext(mesh=_StandIn((1, n_model), ("data", "model")))
    ops = get_model(cfg)
    split = split_layers(params, ops.stacked_layers)
    by_pos = [tp.model_slices(params, ctx, pos) for pos in range(n_model)]
    mix = [s["layers"]["mixer"] for s in by_pos]
    want_in = np.r_[np.ones(2 * DI), np.full(2 * N, n_model), np.ones(H)]
    np.testing.assert_array_equal(
        _owners([m["in_proj"] for m in mix], 2 * DI + 2 * N + H, 2),
        want_in)
    for key, width, dim in (("conv_w", DI, 2), ("out_proj", DI, 1),
                            ("A_log", H, 1), ("dt_bias", H, 1),
                            ("D_skip", H, 1)):
        np.testing.assert_array_equal(
            _owners([m[key] for m in mix], width, dim), np.ones(width), key)
    for pos, s in enumerate(by_pos):
        c, h = DI // n_model, H // n_model
        assert s["layers"]["mixer"]["in_proj"].ranges == [
            (pos * c, (pos + 1) * c), (DI + pos * c, DI + (pos + 1) * c),
            (2 * DI, 2 * DI + 2 * N),
            (2 * DI + 2 * N + pos * h, 2 * DI + 2 * N + (pos + 1) * h)]
        assert not s["layers"]["norm"] and not s["final_norm"]
        whole = tp.take_model_slices(params, s)
        cut = tp.take_model_slices(
            split, tp.model_slices(split, ctx, pos))
        for lp_w, lp_c in zip(unstack_layers(whole["layers"],
                                             cfg.n_layers), cut["layers"]):
            for (p1, a), (_, b) in zip(flatten_with_path(lp_w)[0],
                                       flatten_with_path(lp_c)[0]):
                assert torch.equal(a.reshape(b.shape), b), keystr(p1)


def test_hybrid_shared_block_is_cut_as_its_specs():
    """The hybrid's shared block is one unstacked layer: each leaf's cut is
    the ``model`` entry of the reference's spec for the leaf stacked over
    one layer, one dim down, in both layouts."""
    cfg, params = _params("zamba2-1.2b")
    mesh = _StandIn((2, 2), ("data", "model"))
    ctx = tp.DistContext(mesh=mesh)
    stacked = tree_map(lambda x: np.empty((1,) + tuple(x.shape)),
                       params["shared"])
    specs = dict((keystr(k), v) for k, v in flatten_with_path(
        jp.param_partition_specs(stacked, jp.DistContext(mesh=mesh)))[0])
    split = split_layers(params, get_model(cfg).stacked_layers)
    for pos in (0, 1):
        sl = tp.model_slices(params, ctx, pos)["shared"]
        n_cut = 0
        for (path, leaf), (_, s) in zip(
                flatten_with_path(params["shared"])[0],
                flatten_with_path(sl)[0]):
            k = keystr(path)
            spec = specs[k]
            if "model" in spec:
                dim = list(spec).index("model") - 1
                n = leaf.shape[dim] // 2
                assert tuple(s) == (dim, pos * n, (pos + 1) * n), k
                n_cut += 1
            else:
                assert not s, k
        assert n_cut == 7
        whole = tp.take_model_slices(params, tp.model_slices(params, ctx,
                                                             pos))
        cut = tp.take_model_slices(split, tp.model_slices(split, ctx, pos))
        for (p1, a), (_, b) in zip(flatten_with_path(whole["shared"])[0],
                                   flatten_with_path(cut["shared"])[0]):
            assert torch.equal(a.reshape(b.shape), b), keystr(p1)


def test_tensor_parallel_needs_the_ssd_heads_to_split():
    cfg = dataclasses.replace(get_config("mamba2-370m", reduced=True),
                              ssm_headdim=64)          # 8 SSD heads
    with pytest.raises(ValueError, match="mamba2-370m.*ssm_heads"):
        tp.check_tensor_parallel(cfg, 16)
    tp.check_tensor_parallel(cfg, 8)
    params = get_model(cfg).init_params(torch.Generator().manual_seed(0),
                                        cfg, device="cpu")
    with pytest.raises(ValueError, match="8 SSD heads"):
        tp.model_slices(params, tp.DistContext(
            mesh=_StandIn((1, 16), ("data", "model"))), 0)


@pytest.mark.parametrize("name", ARCHS + (ODD,))
def test_one_position_mesh_is_the_ctx_less_path(name):
    """A ``(1, 1)`` mesh (no process group): ``train_loss`` and its
    gradient are the ctx-less calls bit for bit, and so is the mixer."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import ssm
    from repro_torch.training.step import loss_and_grad
    cfg, params = _params(name)
    ctx = tp.make_dist_ctx(make_host_mesh())
    rng = np.random.default_rng(3)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 33)).astype(
        np.int32))
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    if cfg.family == "audio":
        batch["frames"] = torch.from_numpy(rng.normal(
            size=(2, cfg.enc_seq, cfg.d_model)).astype(np.float32))
    ops = get_model(cfg)
    assert ops.tensor_parallel
    l0, g0 = loss_and_grad(ops, cfg, params, batch)
    l1, g1 = loss_and_grad(ops, cfg, params, batch, ctx)
    assert torch.equal(l0, l1)
    for a, b in zip(flatten_with_path(g0)[0], flatten_with_path(g1)[0]):
        assert torch.equal(a[1], b[1]), keystr(a[0])
    if name in MIXERS:
        mixer = unstack_layers(params["layers"], cfg.n_layers)[0]["mixer"]
        x = torch.from_numpy(rng.normal(size=(2, 32, cfg.d_model)).astype(
            np.float32))
        assert torch.equal(ssm.mixer_fwd(x, mixer, cfg),
                           ssm.mixer_fwd(x, mixer, cfg, ctx))


@pytest.mark.parametrize("name", MIXERS)
def test_numpy_tree_placed_as_model_slices(name):
    """``from_numpy_tree`` with a rank's ``model_slices`` places exactly
    what ``take_model_slices`` cuts from the whole tree, ``in_proj``'s four
    column ranges concatenated."""
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
        assert placed["layers"]["mixer"]["in_proj"].shape[-1] == (
            cfg.d_inner + 2 * cfg.ssm_state + cfg.ssm_heads // 2)
