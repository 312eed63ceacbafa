"""The microbatched mesh train step against the reference's on a forced
4-device CPU mesh.

Reduced qwen2-1.5b in f32 on a ``(2, 2)`` ``("data", "model")`` mesh,
the reference's stacked partition, adamw, microbatch 2, three steps on
the same initial parameters and global batches (drawn by the reference),
once with f32 and once with bf16 moments. The reference runs its jitted
arena step (``repro.training.step.make_arena_train_step``) in one
subprocess (``XLA_FLAGS`` forcing 4 CPU devices); the port runs
``make_arena_train_step`` on 4 gloo ranks in subprocesses (one torch
thread each, a ``file://`` rendezvous in the test's directory). Each data
position's rows are the halves of the reference's microbatches, so the
port's microbatch ``i`` over the data line is the reference's microbatch
``i``.

- the port packs the reference's initial arena bit for bit (the two
  layouts are one);
- the losses within rtol 1e-5 of the reference's, the parameters'
  update (the arena after the steps less the initial arena), the first
  and second moments after the first step and after the last within a
  relative L2 of ``TOL[moments]`` of the reference's: the same sum of
  each microbatch's mean gradient over the mesh, divided by the
  microbatches, in the reference's accumulator dtype;
- the tolerance bites: with f32 moments, the port's bf16-moment run
  misses it; with bf16 moments, the order this step replaced (the
  microbatches added on the rank in bf16, then reduced; the whole-slice
  route of ``tests/test_torch_mesh_layer_gather.py``) misses it.

The processes of this file run at a lower CPU priority (``nice``), so
that under a loaded test run they yield to the tests that share the host.
"""
import importlib.util
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

from repro.configs import get_config as j_get_config
from repro.data.pipeline import ShardedLMDataset as JDataset
from repro.models import get_model as j_get_model
from repro.sharding import single_device_ctx

HERE = Path(__file__).resolve().parent
SRC = HERE.parent / "src"
DEADLINE = 150
NAME = "qwen2-1.5b"
B, S, MB, STEPS, LR = 8, 32, 2, 3, 3e-3
MOMENTS = ("float32", "bfloat16")
# The holds against the reference. The f32 sums run in another order
# (the reference's GSPMD reduction, the port's gloo one): the first step's
# moments (the first gradient in them) agree to a few f32 roundings, and
# with bf16 moments a few of their bf16 roundings flip. Adam turns a
# near-zero gradient's last bits into a whole update, so the parameters
# and the losses drift apart a little more with each step.
LOSS_RTOL = 3e-5
PARAMS_TOL = 5e-4                                   # relative L2
MOMENTS_TOL = {"float32": 1e-5, "bfloat16": 5e-4}   # relative L2, step 1
BF16_FLIPS = 0.01            # the share of bf16 moments that may differ
# this file's processes yield the CPU to the tests that share the host
NICE = ("nice", "-n", "10")

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
data = pickle.load(open(f"{out}/data.pkl", "rb"))
mesh = make_mesh_compat((2, 2), ("data", "model"))
ctx = make_dist_ctx(mesh)


def f32(a):
    """An arena's words as their f32 values, a moment buffer as f32."""
    a = np.asarray(a)
    return a.view(np.float32) if a.dtype.kind in "iu" \
        else a.astype(np.float32)


res = {}
for md in %(moments)r:
    cfg = dataclasses.replace(get_config(%(name)r, reduced=True),
                              dtype="float32", microbatch=%(mb)d,
                              opt_moment_dtype=md)
    ops = get_model(cfg)
    params = jax.tree_util.tree_map(jnp.asarray, data["params"])
    layout = build_arena_layout(partition_pytree(params, block_rows=8),
                                shards=4)
    opt = adamw(%(lr)r, moment_dtype=jnp.dtype(md))
    arena = pack_arena(params, layout)
    state = shard_arena_state(ArenaTrainState.create(arena, opt, layout),
                              mesh)
    step = jax.jit(make_arena_train_step(ops, cfg, ctx, opt, layout))
    r = {"init": f32(arena), "losses": [], "after": []}
    for batch in data["batches"]:
        batch = {k: jax.device_put(v, NamedSharding(mesh, P("data")))
                 for k, v in batch.items()}
        state, loss = step(state, batch)
        r["losses"].append(float(loss))
        r["after"].append((f32(state.arena), f32(state.opt_state.mu),
                           f32(state.opt_state.nu)))
    res[md] = r
pickle.dump(res, open(f"{out}/ref.pkl", "wb"))
print("REF-OK")
''' % {"moments": MOMENTS, "name": NAME, "mb": MB, "lr": LR}

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
from repro_torch.core.arena import build_arena_layout, pack_arena
from repro_torch.core.blocks import partition_pytree
from repro_torch.distributed import collectives
from repro_torch.interop import from_numpy_tree
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import get_model
from repro_torch.models.layers import torch_dtype
from repro_torch.optim import adamw
from repro_torch.sharding.partition import make_dist_ctx
from repro_torch.training.step import make_arena_train_step
from repro_torch.training.train_state import ArenaTrainState

collectives.CHUNK_BYTES = 1 << 16
data = pickle.load(open(f"{out}/data.pkl", "rb"))
env = {}
exec(open(f"{out}/routes.py").read(), env)
mesh = make_host_mesh(model=2)
ctx = make_dist_ctx(mesh)
comm = mesh.comm()
d, n_data = mesh.axis_position("data"), world // 2


def local(x):
    """This data position's rows of a global batch: its half of each
    microbatch's rows, microbatch by microbatch."""
    rows = x.shape[0] // %(mb)d
    per = rows // n_data
    return torch.from_numpy(np.concatenate(
        [x[i * rows + d * per:i * rows + (d + 1) * per]
         for i in range(%(mb)d)]))


def f32(t):
    return t.view(torch.float32) if t.dtype == torch.int32 \
        else t.to(torch.float32)


params = from_numpy_tree(data["params"], "cpu")
res = {"rank": rank}
for md in %(moments)r:
    cfg = dataclasses.replace(get_config(%(name)r, reduced=True),
                              dtype="float32", microbatch=%(mb)d,
                              opt_moment_dtype=md)
    ops = get_model(cfg)
    layout = build_arena_layout(partition_pytree(params, block_rows=8),
                                shards=world)
    arena = pack_arena(params, layout)
    w0, w1 = layout.span(mesh.position())
    opt = adamw(%(lr)r, moment_dtype=torch_dtype(md))
    res[md] = {"span": (w0, w1)}
    if rank == 0:
        res[md]["init"] = f32(arena).numpy().copy()
    # the order this step replaced, where the moments' dtype shows it
    for route in ("layers",) + (("replaced",) if md == "bfloat16" else ()):
        state = ArenaTrainState.create(arena[w0:w1].clone(), opt, layout)
        if route == "layers":
            step = make_arena_train_step(ops, cfg, opt, layout, comm, ctx)
        else:
            step = env["whole_slice_step"](ops, cfg, opt, layout, comm, ctx,
                                           order="replaced")
        r = {"losses": [], "after": []}
        for batch in data["batches"]:
            state, loss = step(state, {k: local(v) for k, v in batch.items()})
            r["losses"].append(float(loss))
            r["after"].append(tuple(
                f32(x).numpy().copy() for x in (
                    state.arena, state.opt_state.mu, state.opt_state.nu)))
        res[md][route] = r
pickle.dump(res, open(f"{out}/rank_{rank}.pkl", "wb"))
dist.destroy_process_group()
''' % {"moments": MOMENTS, "name": NAME, "mb": MB, "lr": LR}


def _reference(out: Path) -> dict:
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.run([*NICE, sys.executable, "-c", REF, str(out)],
                          capture_output=True, text=True, timeout=DEADLINE,
                          env=env)
    assert proc.returncode == 0 and "REF-OK" in proc.stdout, (
        f"the reference's subprocess failed:\n{proc.stderr[-4000:]}")
    return pickle.load(open(out / "ref.pkl", "rb"))


def _ranks(out: Path, world: int = 4) -> list:
    """The port's 4 gloo ranks; their reports in rank order. Fails when a
    rank fails or the ranks outlive ``DEADLINE`` seconds."""
    (out / "rank.py").write_text(RANK)
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


def _routes() -> str:
    """The whole-slice routes of ``test_torch_mesh_layer_gather.py``."""
    spec = importlib.util.spec_from_file_location(
        "_layer_gather_routes", HERE / "test_torch_mesh_layer_gather.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.ROUTES


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's draws (its initial parameters and global batches),
    then its mesh run and the port's ranks side by side."""
    out = tmp_path_factory.mktemp("mesh_microbatch")
    jcfg = j_get_config(NAME, reduced=True)
    params = j_get_model(jcfg).init_params(jax.random.PRNGKey(0), jcfg)
    ds = JDataset(jcfg, B, S, single_device_ctx(), seed=5)
    batches = [jax.tree_util.tree_map(np.asarray, ds.next_batch())
               for _ in range(STEPS)]
    with open(out / "data.pkl", "wb") as f:
        pickle.dump({"params": jax.tree_util.tree_map(
            lambda x: np.asarray(x, np.float32), params),
            "batches": batches}, f)
    (out / "routes.py").write_text(_routes())
    with ThreadPoolExecutor(2) as pool:
        ref = pool.submit(_reference, out)
        ranks = pool.submit(_ranks, out)
        return ref.result(), ranks.result()


def _whole(ranks: list, md: str, route: str, k: int, which: int
           ) -> np.ndarray:
    """The ranks' spans of step ``k``'s buffer ``which`` (arena, mu, nu),
    in position order: the whole buffer."""
    return np.concatenate([r[md][route]["after"][k][which] for r in ranks])


def _rel(a: np.ndarray, b: np.ndarray) -> float:
    a, b = a.astype(np.float64), b.astype(np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _gaps(ref: dict, ranks: list, md: str, route: str,
          ref_md: str = None) -> dict:
    """The port's ``route`` run with ``md`` moments against the
    reference's run with ``ref_md`` (default ``md``): the losses' largest
    relative gap, the parameters' relative L2 gap after each step, the
    moments' after the first step, and the share of the first step's
    moments that differ."""
    want = ref[ref_md or md]
    got = ranks[0][md][route]["losses"]
    mu, nu = (_whole(ranks, md, route, 0, i) for i in (1, 2))
    return {"loss": max(abs(a - b) / abs(b)
                        for a, b in zip(got, want["losses"])),
            "params": max(_rel(_whole(ranks, md, route, k, 0),
                               want["after"][k][0]) for k in range(STEPS)),
            "moments": max(_rel(mu, want["after"][0][1]),
                           _rel(nu, want["after"][0][2])),
            "flips": float(np.mean(np.concatenate(
                [mu != want["after"][0][1], nu != want["after"][0][2]])))}


def _held(g: dict, md: str) -> dict:
    """Which of the holds the gaps ``g`` meet, for ``md`` moments."""
    return {"loss": g["loss"] <= LOSS_RTOL,
            "params": g["params"] <= PARAMS_TOL,
            "moments": g["moments"] <= MOMENTS_TOL[md]
            and (md == "float32" or g["flips"] <= BF16_FLIPS)}


def test_port_packs_the_reference_arena(runs):
    ref, ranks = runs
    for md in MOMENTS:
        assert np.array_equal(ranks[0][md]["init"].view(np.int32),
                              ref[md]["init"].view(np.int32))
        spans = [r[md]["span"] for r in ranks]
        assert spans[0][0] == 0 and spans[-1][1] == ref[md]["init"].size
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))


@pytest.mark.parametrize("md", MOMENTS)
def test_microbatched_mesh_step_matches_reference(runs, md):
    ref, ranks = runs
    for r in ranks:
        assert r[md]["layers"]["losses"] == ranks[0][md]["layers"]["losses"]
        assert all(np.isfinite(r[md]["layers"]["losses"]))
    gaps = _gaps(ref, ranks, md, "layers")
    print(f"{md} moments, the port against the reference: {gaps}")
    assert all(_held(gaps, md).values()), gaps
    # the steps moved the parameters
    assert _rel(ref[md]["after"][-1][0], ref[md]["init"]) > 10 * PARAMS_TOL
    # the tolerances bite: with f32 moments, bf16 ones; with bf16 moments,
    # the order this step replaced
    other = ("bfloat16", "layers") if md == "float32" else (md, "replaced")
    miss = _gaps(ref, ranks, *other, ref_md=md)
    print(f"{md} moments, the port's {other} run against the reference: "
          f"{miss}")
    held = _held(miss, md)
    assert not held["params"] and not held["moments"], miss
