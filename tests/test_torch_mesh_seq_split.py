"""The train stacks' carry between layers split over the model axis
(Megatron sequence parallelism: ``models.layers.seq_axis``, the
``split``, ``gather`` and ``scatter`` of
``distributed.collectives.ModelAxis``) against the replicated carry, one
rank and the reference's own mesh step.

In process:

- ``seq_axis`` takes a model line that divides the sequence and nothing
  else (no model axis, a sequence of 1, one that does not divide);
- the slice plan sums the stacks' norms over the model line (every
  model position contributes) and keeps a VLM's projector, the router and
  a whole vocab at model position 0 alone;
- on meta, rank 0 of the dry ``(16, 16)`` mesh running granite-8b and
  qwen3-moe at full width, 2 and 4 layers, 512 tokens: each layer's saved
  carry is the rank's ``512 / 16`` rows, and a layer adds ``1 - 1/16``
  of its replicated checkpoint less to the step's peak than on the
  replicated route; a prefill makes no sequence-parallel call.

gloo jobs (one torch thread a rank, a deadline a job, at a lower CPU
priority, as ``tests/test_torch_mesh_layer_gather.py``), f32, the
reference's initial parameters and global batch (as numpy), per-layer
leaves, one adamw step of the arena step: reduced qwen2-1.5b on ``(2,
2)`` and ``(1, 4)``, qwen3-moe on ``(1, 4)`` with ``moe_reduce_scatter``
off and on, internvl2 on ``(1, 4)`` (the patch prefix), and on ``(1,
2)`` mamba2-370m, zamba2-1.2b (the shared block used twice),
whisper-medium, and whisper with an encoder of 63 frames and a vocab of
1,023 (a replicated encoder beside a split decoder; the embedding, the
head and the loss whole on every rank). The replicated route is the
carry a non-dividing sequence keeps (``seq_axis`` answering None):

- the losses ``torch.equal``;
- every leaf's reduced gradient ``torch.equal``, but the stacks' norms
  (``partition.acts_on_pieces``: each rank's part of their sum, added by
  the slice plan in another order than the replicated route's whole sum
  over S), within 1e-6 relative L2;
- every leaf within a relative L2 of 1e-4 of one rank's gradient (the
  mean of the data shards' gradients taken without a mesh), the
  tolerance of ``tests/test_torch_mesh_tp.py``.

Against the reference's own mesh step on 4 forced CPU devices (the
machinery of ``tests/test_torch_mesh_microbatch_reference.py``): reduced
qwen2-1.5b and qwen3-moe on ``(1, 4)``, the reference's stacked
partition, microbatch 2, f32 moments, three adamw steps: the losses within
rtol 3e-5, the parameters within 5e-4 (relative L2, every step), the
first step's moments within 1e-5.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.data.pipeline import ShardedLMDataset as JDataset
from repro.models import get_model as j_get_model
from repro.sharding import single_device_ctx
from repro_torch.configs import get_config
from repro_torch.core.arena import build_arena_layout, pack_arena
from repro_torch.core.blocks import partition_pytree
from repro_torch.interop import from_numpy_tree
from repro_torch.launch.mesh import make_dry_mesh, make_dry_production_mesh
from repro_torch.models import get_model, layers
from repro_torch.models.layers import split_layers
from repro_torch.sharding.partition import (OUTER, SlicePlan, acts_on_pieces,
                                            make_dist_ctx, model_slices)
from repro_torch.utils.tree import (flatten_with_path, keystr, tree_flatten,
                                    tree_unflatten)

HERE = Path(__file__).resolve().parent
SRC = HERE.parent / "src"
# a job's wall: a loaded host stretches a job 2-3x (the ranks' gloo
# timeout, 120 s a collective, fails a hung one first)
DEADLINE = 300
# the gloo ranks and the reference yield the CPU to the tests that share
# the host
NICE = ("nice", "-n", "10")
B, S = 4, 16
NORM_RTOL = 1e-6          # the norms' gradients, summed in another order
ONE_RANK_TOL = 1e-4       # relative L2, leaf by leaf
# the reference-mesh holds of tests/test_torch_mesh_microbatch_reference.py
REF_NAMES = ("qwen2-1.5b", "qwen3-moe-235b-a22b")
REF_B, REF_S, REF_MB, REF_STEPS, REF_LR = 8, 32, 2, 3, 3e-3
LOSS_RTOL, PARAMS_TOL, MOMENTS_TOL = 3e-5, 5e-4, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jcfg(name: str, over: dict):
    """The reference's reduced config with ``over`` (the reference's
    fields: ``vocab``, ``enc_seq``)."""
    return dataclasses.replace(j_get_config(name, reduced=True), **{
        k: v for k, v in over.items() if k in ("vocab", "enc_seq")})


def _draws(name: str, over: dict, batch: int, seq: int, seed: int = 0):
    """The reference's initial parameters (f32) and one global batch, as
    numpy."""
    jcfg = _jcfg(name, over)
    params = j_get_model(jcfg).init_params(jax.random.PRNGKey(seed), jcfg)
    ds = JDataset(jcfg, batch, seq, single_device_ctx(), seed=5)
    return (jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32),
                                   params),
            jax.tree_util.tree_map(np.asarray, ds.next_batch()))


# ---------------------------------------------------------------------------
# in process
# ---------------------------------------------------------------------------

def test_seq_axis_takes_a_model_line_that_divides_the_sequence():
    mesh = make_dry_mesh((2, 2), ("data", "model"), position=1)
    ctx = make_dist_ctx(mesh)
    axis = layers.seq_axis(ctx, 16)
    assert axis is not None and axis.size == 2 and axis.pos == 1
    assert layers.seq_axis(ctx, 15) is None
    assert layers.seq_axis(ctx, 1) is None
    assert layers.seq_axis(None, 16) is None
    one = make_dist_ctx(make_dry_mesh((4, 1), ("data", "model")))
    assert layers.seq_axis(one, 16) is None


PLAN_CASES = [("internvl2-76b", (1, 4)), ("whisper-medium", (2, 2)),
              ("zamba2-1.2b", (1, 2)), ("qwen3-moe-235b-a22b", (1, 4))]


@pytest.mark.parametrize("name,shape", PLAN_CASES,
                         ids=[f"{n}-{s[0]}x{s[1]}" for n, s in PLAN_CASES])
def test_plan_sums_the_norms_over_the_model_line(name, shape):
    """Each owner's reduce at model position 1: the words of every norm
    of the carry (those of a position-0 rank too), none of a leaf
    computed whole (the router, a VLM's projector, the frame projection);
    at position 0 every word its slices cover."""
    cfg = get_config(name, reduced=True)
    ops = get_model(cfg)
    params = split_layers(from_numpy_tree(_draws(name, {}, 2, 8)[0], "cpu"),
                          ops.stacked_layers)
    n = int(np.prod(shape))
    layout = build_arena_layout(partition_pytree(params, block_rows=8),
                                shards=n)
    sw = layout.shard_words
    names = [keystr(p) for p, _ in flatten_with_path(params)[0]]
    leaves = tree_flatten(params)[0]

    def words(which) -> torch.Tensor:
        """An arena mask of the leaves ``which`` picks (by index)."""
        return pack_arena(tree_unflatten(tree_flatten(params)[1], [
            torch.full(x.shape, float(which(i))) for i, x in
            enumerate(leaves)]), layout).view(torch.float32)
    norms = words(lambda i: acts_on_pieces(names[i]))
    whole = [i for i, x in enumerate(tree_flatten(model_slices(
        params, make_dist_ctx(make_dry_mesh(shape, ("data", "model")))))[0])
        if not x and not acts_on_pieces(names[i])]
    assert norms.sum() > 0
    for family, part in (("vlm", "projector"), ("moe", "router"),
                         ("audio", "frame_proj")):
        if cfg.family == family:
            assert any(part in names[i] for i in whole), part
    whole_words = words(lambda i: i in whole)
    for m in (0, 1):
        mesh = make_dry_mesh(shape, ("data", "model"), position=m)
        plan = SlicePlan(layout, mesh, make_dist_ctx(mesh))
        got = torch.zeros((n * sw,))
        cover = torch.zeros((n * sw,))
        for q in range(n):
            for b in plan.reduce_boxes(q, m, OUTER):
                b.arena_view(got, 0).add_(1.0)
            for b in plan.gather_boxes(q, m, OUTER):
                b.arena_view(cover, 0).add_(1.0)
        assert torch.equal(got * norms[:n * sw], norms[:n * sw]), m
        if m == 0:
            assert torch.equal(got, cover)
        else:
            assert float((got * whole_words[:n * sw]).sum()) == 0.0
            assert torch.equal(got, cover * (1 - whole_words[:n * sw]))


@pytest.mark.parametrize("name", ("granite-8b", "qwen3-moe-235b-a22b"))
def test_carry_is_the_ranks_piece_and_the_peak_falls_on_meta(name):
    """Rank 0 of the dry (16, 16) mesh at full width, 512 tokens a
    sequence (16 a rank): each remat layer's input is the rank's 32 rows,
    the replicated route's 512; two more layers add ``1 - 1/16`` of two
    replicated checkpoints (16 x 512 x D f32) less to the peak than on the
    replicated route. The prefill keeps the replicated carry: no
    sequence-parallel call."""
    from repro_torch.distributed import collectives
    from repro_torch.launch import dryrun
    real, remat = layers.seq_axis, layers.remat
    seen: list = []

    def recording(fn, *args, enabled=True):
        seen.append(tuple(args[0].shape))
        return remat(fn, *args, enabled=enabled)
    temp = {}
    try:
        layers.remat = recording
        for route in ("seq", "replicated"):
            layers.seq_axis = real if route == "seq" \
                else (lambda ctx, S: None)
            for depth in (2, 4):
                cfg = dataclasses.replace(get_config(name), n_layers=depth)
                seen.clear()
                step = dryrun.build_rank_step(
                    cfg, "train", 256, 512, make_dry_production_mesh(),
                    "meta")
                temp[route, depth] = dryrun.measure(step)[
                    "memory"]["temp_bytes"]
                rows = 32 if route == "seq" else 512
                assert seen and set(seen) == {(16, rows, cfg.d_model)}
    finally:
        layers.seq_axis, layers.remat = real, remat
    ckpt = 16 * 512 * get_config(name).d_model * 4
    drop = (temp["replicated", 4] - temp["replicated", 2]) \
        - (temp["seq", 4] - temp["seq", 2])
    assert drop == 2 * ckpt * 15 // 16, (drop, temp)
    assert temp["seq", 4] < temp["replicated", 4]
    cfg = dataclasses.replace(get_config(name), n_layers=1)
    step = dryrun.build_rank_step(cfg, "prefill", 32, 512,
                                  make_dry_production_mesh(), "meta")
    collectives.reset_stats()
    dryrun.measure(step)
    assert not [k for k in collectives.STATS if k.startswith("seq_")]


NORM_CASES = ("qwen2-1.5b", "qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b",
              "internvl2-76b", "mamba2-370m", "zamba2-1.2b", "whisper-medium")


@pytest.mark.parametrize("route", ("seq", "replicated"))
@pytest.mark.parametrize("name", NORM_CASES)
def test_train_stacks_apply_their_norms_through_carry_norm(name, route):
    """Rank 0 of a dry ``(1, 2)`` mesh runs each family's ``train_loss``
    (the values of the other rank unset: shapes alone matter here), on the
    sequence-parallel and the replicated route. Every norm weight goes
    through ``layers.carry_norm`` and no other ``rms_norm`` call runs, and
    the keys it gets are those of the tree's leaves that
    ``partition.CARRY_NORMS`` lists: the list, the plan's rule and the
    models' call sites agree. ``carry_norm`` refuses an unlisted key."""
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.sharding.partition import take_model_slices
    cfg = get_config(name, reduced=True)
    ops = get_model(cfg)
    gen = torch.Generator().manual_seed(0)
    params = split_layers(ops.init_params(gen, cfg, device="cpu"),
                          ops.stacked_layers)
    ctx = make_dist_ctx(make_dry_mesh((1, 2), ("data", "model")))
    mine = take_model_slices(params, model_slices(params, ctx))
    batch = lm_batch(gen, cfg, 2, 16, device="cpu")
    real_norm, real_carry, real_seq = (layers.rms_norm, layers.carry_norm,
                                       layers.seq_axis)
    keys: set = set()
    plain: list = []
    inside = [False]

    def carry(x, p, key, *a, **k):
        keys.add(key)
        inside[0] = True
        try:
            return real_carry(x, p, key, *a, **k)
        finally:
            inside[0] = False

    def norm(x, w, *a, **k):
        if not inside[0]:
            plain.append(tuple(w.shape))
        return real_norm(x, w, *a, **k)
    try:
        layers.rms_norm, layers.carry_norm = norm, carry
        if route == "replicated":
            layers.seq_axis = lambda c, S: None
        loss = ops.train_loss(mine, batch, cfg, ctx=ctx)
    finally:
        layers.rms_norm, layers.carry_norm, layers.seq_axis = (
            real_norm, real_carry, real_seq)
    assert loss.shape == ()
    assert not plain, plain
    listed = {keystr(p).rsplit("'", 2)[-2]
              for p, _ in flatten_with_path(params)[0]
              if acts_on_pieces(keystr(p))}
    assert listed and keys == listed, (keys, listed)
    with pytest.raises(ValueError, match="not a norm of the carry"):
        layers.carry_norm(torch.ones(2, 4), {"scale": torch.ones(4)},
                          "scale")


# ---------------------------------------------------------------------------
# gloo jobs
# ---------------------------------------------------------------------------

RANK = r'''
import dataclasses, datetime, pickle, sys
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
rank, world, rdv, out = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                         sys.argv[4])
dist.init_process_group("gloo", init_method=f"file://{rdv}", rank=rank,
                        world_size=world,
                        timeout=datetime.timedelta(seconds=120))
from repro_torch.configs import get_config
from repro_torch.core.arena import build_arena_layout, pack_arena, unpack_arena
from repro_torch.core.blocks import partition_pytree
from repro_torch.data.pipeline import slice_batch
from repro_torch.distributed import collectives
from repro_torch.interop import from_numpy_tree
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import get_model, layers
from repro_torch.models.layers import split_layers
from repro_torch.optim import adamw
from repro_torch.sharding.partition import make_dist_ctx
from repro_torch.training.step import loss_and_grad, make_arena_train_step
from repro_torch.training.train_state import ArenaTrainState
from repro_torch.utils.tree import flatten_with_path, keystr, tree_flatten
import repro_torch.training.step as step_module

collectives.CHUNK_BYTES = 1 << 16
tasks = pickle.load(open(f"{out}/tasks.pkl", "rb"))
first = []


def recording(apply):
    """``arena_apply`` that keeps a copy of the first gradient it gets."""
    def call(optimizer, grads, *a, **k):
        if not first:
            first.append(grads.to(torch.float32, copy=True))
        return apply(optimizer, grads, *a, **k)
    return call


step_module.arena_apply = recording(step_module.arena_apply)
real = layers.seq_axis


def f32(t):
    return t.view(torch.float32) if t.dtype == torch.int32 \
        else t.to(torch.float32)


res = {"rank": rank}
for t in tasks:
    mesh = make_host_mesh(model=t["model"])
    ctx = make_dist_ctx(mesh)
    comm = mesh.comm()
    pos = mesh.position()
    cfg = dataclasses.replace(get_config(t["name"], reduced=True),
                              dtype="float32", **t["over"])
    ops = get_model(cfg)
    params = from_numpy_tree(t["params"], "cpu")
    if t["kind"] == "route":
        params = split_layers(params, ops.stacked_layers)
    layout = build_arena_layout(partition_pytree(params, block_rows=8),
                                shards=world)
    arena = pack_arena(params, layout)
    w0, w1 = layout.span(pos)
    opt = adamw(3e-3)
    r = {}
    if t["kind"] == "route":
        batch = dict(slice_batch(t["batch"], mesh, "cpu", True))
        for route in ("seq", "replicated"):
            layers.seq_axis = real if route == "seq" \
                else (lambda c, S: None)
            state = ArenaTrainState.create(arena[w0:w1].clone(), opt,
                                           layout)
            step = make_arena_train_step(ops, cfg, opt, layout, comm, ctx)
            first.clear()
            collectives.reset_stats()
            state, loss = step(state, batch)
            st = collectives.seconds_and_bytes()
            g = comm.all_gather(first[0]).view(torch.int32)
            r[route] = {"loss": float(loss),
                        "seq_calls": {k: v["calls"] for k, v in st.items()
                                      if k.startswith("seq_")}}
            if rank == 0:
                tree = unpack_arena(g, layout)
                r[route]["grads"] = [
                    (keystr(p), x.numpy().copy())
                    for p, x in flatten_with_path(tree)[0]]
        layers.seq_axis = real
        if rank == 0:
            # one rank: the mean of the data shards' gradients, no mesh
            rows = next(iter(t["batch"].values())).shape[0]
            nd = world // t["model"]
            acc = None
            for d in range(nd):
                part = {k: torch.from_numpy(v[d * rows // nd:
                                              (d + 1) * rows // nd].copy())
                        for k, v in t["batch"].items()}
                _, g = loss_and_grad(ops, cfg, params, part)
                g = tree_flatten(g)[0]
                acc = g if acc is None else [a + b for a, b in zip(acc, g)]
            r["one"] = [(x / nd).numpy() for x in acc]
    else:
        # the reference-mesh run: its stacked partition, microbatch rows
        # of each data position, three steps
        mb = cfg.microbatch
        d, nd = mesh.axis_position("data"), world // t["model"]

        def local(x):
            rows = x.shape[0] // mb
            per = rows // nd
            return torch.from_numpy(np.concatenate(
                [x[i * rows + d * per:i * rows + (d + 1) * per]
                 for i in range(mb)]))
        state = ArenaTrainState.create(arena[w0:w1].clone(), opt, layout)
        step = make_arena_train_step(ops, cfg, opt, layout, comm, ctx)
        r = {"span": (w0, w1), "losses": [], "after": []}
        if rank == 0:
            r["init"] = f32(arena).numpy().copy()
        for b in t["batches"]:
            state, loss = step(state, {k: local(v) for k, v in b.items()})
            r["losses"].append(float(loss))
            r["after"].append(tuple(f32(x).numpy().copy() for x in (
                state.arena, state.opt_state.mu, state.opt_state.nu)))
    res[t["key"]] = r
pickle.dump(res, open(f"{out}/rank_{rank}.pkl", "wb"))
dist.destroy_process_group()
'''

REF = r'''
import dataclasses, pickle, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.core.arena import build_arena_layout, pack_arena
from repro.core.blocks import partition_pytree
from repro.launch.mesh import make_mesh_compat
from repro.models import get_model
from repro.optim.optimizers import adamw
from repro.sharding.partition import make_dist_ctx, shard_arena_state
from repro.training.step import make_arena_train_step
from repro.training.train_state import ArenaTrainState

out = sys.argv[1]
data = pickle.load(open(f"{out}/ref_data.pkl", "rb"))
mesh = make_mesh_compat((1, 4), ("data", "model"))
ctx = make_dist_ctx(mesh)


def f32(a):
    a = np.asarray(a)
    return a.view(np.float32) if a.dtype.kind in "iu" \
        else a.astype(np.float32)


res = {}
for name, d in data.items():
    cfg = dataclasses.replace(get_config(name, reduced=True),
                              dtype="float32", microbatch=d["mb"])
    ops = get_model(cfg)
    params = jax.tree_util.tree_map(jnp.asarray, d["params"])
    layout = build_arena_layout(partition_pytree(params, block_rows=8),
                                shards=4)
    opt = adamw(d["lr"], moment_dtype=jnp.float32)
    arena = pack_arena(params, layout)
    state = shard_arena_state(ArenaTrainState.create(arena, opt, layout),
                              mesh)
    step = jax.jit(make_arena_train_step(ops, cfg, ctx, opt, layout))
    r = {"init": f32(arena), "losses": [], "after": []}
    for batch in d["batches"]:
        batch = {k: jax.device_put(v, NamedSharding(mesh, P("data")))
                 for k, v in batch.items()}
        state, loss = step(state, batch)
        r["losses"].append(float(loss))
        r["after"].append((f32(state.arena), f32(state.opt_state.mu),
                           f32(state.opt_state.nu)))
    res[name] = r
pickle.dump(res, open(f"{out}/ref.pkl", "wb"))
print("REF-OK")
'''


def _reference(out: Path) -> dict:
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.run([*NICE, sys.executable, "-c", REF, str(out)],
                          capture_output=True, text=True, timeout=DEADLINE,
                          env=env)
    assert proc.returncode == 0 and "REF-OK" in proc.stdout, (
        f"the reference's subprocess failed:\n{proc.stderr[-4000:]}")
    return pickle.load(open(out / "ref.pkl", "rb"))


def _ranks(out: Path, world: int, tasks: list) -> list:
    """The rank script's ``tasks`` on ``world`` gloo ranks; their reports
    in rank order. Fails when a rank fails or the ranks outlive
    ``DEADLINE`` seconds."""
    out.mkdir(parents=True, exist_ok=True)
    (out / "rank.py").write_text(RANK)
    with open(out / "tasks.pkl", "wb") as f:
        pickle.dump(tasks, f)
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1",
               GLOO_SOCKET_IFNAME="lo")
    procs = [subprocess.Popen(
        [*NICE, sys.executable, str(out / "rank.py"), str(r), str(world),
         str(out / "rdv"), str(out)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    end = time.monotonic() + DEADLINE
    logs = []
    try:
        for p in procs:
            o, _ = p.communicate(timeout=max(1.0, end - time.monotonic()))
            logs.append(o)
    except subprocess.TimeoutExpired:
        pytest.fail(f"the ranks did not finish in {DEADLINE} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
    return [pickle.load(open(out / f"rank_{r}.pkl", "rb"))
            for r in range(world)]


# (name, model positions, config overrides) of each world's route cases
ROUTES = {
    4: [("qwen2-1.5b", 2, {}), ("qwen2-1.5b", 4, {}),
        ("qwen3-moe-235b-a22b", 4, {}),
        ("qwen3-moe-235b-a22b", 4, {"moe_reduce_scatter": True}),
        ("internvl2-76b", 4, {})],
    2: [("mamba2-370m", 2, {}), ("zamba2-1.2b", 2, {}),
        ("whisper-medium", 2, {}),
        ("whisper-medium", 2, {"enc_seq": 63, "vocab": 1023})]}


def _key(name, model, over) -> str:
    return f"{name}/{model}/" + ",".join(f"{k}={v}" for k, v in
                                         sorted(over.items()))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's draws, then the reference's mesh run and the
    port's two gloo jobs side by side."""
    out = tmp_path_factory.mktemp("seq_split")
    ref_data, tasks = {}, {w: [] for w in ROUTES}
    for name in REF_NAMES:
        jcfg = j_get_config(name, reduced=True)
        params = j_get_model(jcfg).init_params(jax.random.PRNGKey(0), jcfg)
        ds = JDataset(jcfg, REF_B, REF_S, single_device_ctx(), seed=5)
        batches = [jax.tree_util.tree_map(np.asarray, ds.next_batch())
                   for _ in range(REF_STEPS)]
        params = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32),
                                        params)
        ref_data[name] = {"params": params, "batches": batches,
                          "mb": REF_MB, "lr": REF_LR}
        tasks[4].append({"kind": "reference", "key": f"ref/{name}",
                         "name": name, "model": 4, "params": params,
                         "batches": batches, "over": {"microbatch": REF_MB}})
    for world, cases in ROUTES.items():
        for name, model, over in cases:
            params, batch = _draws(name, over, B, S)
            tasks[world].append({"kind": "route",
                                 "key": _key(name, model, over),
                                 "name": name, "model": model,
                                 "over": over, "params": params,
                                 "batch": batch})
    with open(out / "ref_data.pkl", "wb") as f:
        pickle.dump(ref_data, f)
    with ThreadPoolExecutor(3) as pool:
        ref = pool.submit(_reference, out)
        jobs = {w: pool.submit(_ranks, out / f"world{w}", w, t)
                for w, t in tasks.items()}
        return ref.result(), {w: j.result() for w, j in jobs.items()}


def _rel(a: np.ndarray, b: np.ndarray) -> float:
    a, b = a.astype(np.float64), b.astype(np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


ROUTE_CASES = [(w, *c) for w, cases in ROUTES.items() for c in cases]


@pytest.mark.parametrize(
    "world,name,model,over", ROUTE_CASES,
    ids=[f"{n}-{w // m}x{m}" + "".join(f"-{k}" for k in o)
         for w, n, m, o in ROUTE_CASES])
def test_seq_step_is_the_replicated_step_but_the_norms(runs, world, name,
                                                       model, over):
    ranks = runs[1][world]
    key = _key(name, model, over)
    seq, rep = ranks[0][key]["seq"], ranks[0][key]["replicated"]
    for r in ranks:
        assert r[key]["seq"]["loss"] == seq["loss"]
        assert r[key]["replicated"]["loss"] == rep["loss"]
        # the sequence-parallel route ran its collectives, the replicated
        # none
        assert r[key]["seq"]["seq_calls"].get("seq_all_gather", 0) > 0
        assert not r[key]["replicated"]["seq_calls"]
    assert seq["loss"] == rep["loss"] and np.isfinite(seq["loss"])
    moved, norms = {}, 0
    for (p, a), (q, b), one in zip(seq["grads"], rep["grads"],
                                   ranks[0][key]["one"]):
        assert p == q and a.shape == b.shape == one.shape
        assert np.all(np.isfinite(a))
        if acts_on_pieces(p):
            norms += 1
            assert _rel(a, b) <= NORM_RTOL, (p, _rel(a, b))
            if not np.array_equal(a, b):
                moved[p] = _rel(a, b)
        else:
            assert np.array_equal(a.view(np.int32), b.view(np.int32)), p
        assert _rel(a, one) <= ONE_RANK_TOL, (p, _rel(a, one))
    assert norms >= 2
    # which leaves' bits moved, and by how much (``-s``)
    print(f"{key}: norms moved {moved}")


@pytest.mark.parametrize("name", REF_NAMES)
def test_seq_mesh_step_matches_the_reference_mesh(runs, name):
    ref, jobs = runs
    ranks, want = jobs[4], ref[name]
    key = f"ref/{name}"
    assert np.array_equal(ranks[0][key]["init"].view(np.int32),
                          want["init"].view(np.int32))
    for r in ranks:
        assert r[key]["losses"] == ranks[0][key]["losses"]
    got = ranks[0][key]["losses"]
    loss = max(abs(a - b) / abs(b) for a, b in zip(got, want["losses"]))

    def whole(k, i):
        return np.concatenate([r[key]["after"][k][i] for r in ranks])
    params = max(_rel(whole(k, 0), want["after"][k][0])
                 for k in range(REF_STEPS))
    moments = max(_rel(whole(0, i), want["after"][0][i]) for i in (1, 2))
    print(f"{name} (1, 4) against the reference: loss {loss}, params "
          f"{params}, first-step moments {moments}")
    assert loss <= LOSS_RTOL and params <= PARAMS_TOL \
        and moments <= MOMENTS_TOL
    # the steps moved the parameters
    assert _rel(want["after"][-1][0], want["init"]) > 10 * PARAMS_TOL
