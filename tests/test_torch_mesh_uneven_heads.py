"""Query heads that do not split over the model axis, against the
reference's forced 4-device CPU mesh, which cuts ``head_dim`` there.

Each model position takes whole query heads ``[ceil(r Hq / tp), ceil((r+1)
Hq / tp))`` (``partition.query_head_range``) and the kv heads they read
(``partition.kv_head_range``; positions whose ranges read one kv head
each hold it). Reduced qwen2-1.5b (dense) and qwen3-moe-235b-a22b (every
layer MoE, top-2 of 4 experts), f32, ``d_head`` 32 (so that the
reference's own ``head_dim`` cut applies over 4), on a ``(1, 4)``
``("data", "model")`` mesh, with three head overrides:

- 10 query heads over 2 kv heads: 3, 2, 3, 2 heads a position
  (llama4-maverick's 40/8 at 16, in small);
- 6 over 2: 2, 1, 2, 1 (qwen2-1.5b's 12/2 at 8);
- 3 over 1: 1, 1, 1, 0 (qwen2-1.5b's 12/2 at 16): position 3 holds no
  query head, no kv head and no cache columns, and its attention adds a
  zero partial to the reduce after ``wo``.

The reference draws the weights (its ``init_params``) and the batch, and
runs in one subprocess (``XLA_FLAGS`` forcing 4 CPU devices); the port
runs 4 gloo ranks in subprocesses (one torch thread each, a ``file://``
rendezvous) on its numpy draws (``interop.from_numpy_tree``). Held:

- the train loss within rtol 1e-4 and the gradient (each rank's slices
  landing in the whole leaves, summed over the ranks) within a relative L2
  of 1e-4 of ``jax.grad`` on the mesh, leaf by leaf;
- the prefill's last logits and every decode step's within rtol 1e-4 and
  atol 1e-4 of the reference's mesh run, the greedy tokens equal, each
  rank's cache the reference's kv heads that its query heads read; with
  ``kv_quant`` the int8 values within one count and the decode steps run
  from the reference's own cache after its prefill;
- on the 10/2 override of qwen2-1.5b, the arena ``TrainLoop`` (per-layer
  leaves: ``wo`` held 2-D, cut by rows) bit for bit the PyTree one over 2
  steps on the mesh.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.interop import from_numpy_tree, to_numpy_tree
from repro_torch.sharding import partition as tp
from repro_torch.utils.tree import flatten_with_path, keystr

SRC = Path(__file__).resolve().parents[1] / "src"
ARCHS = ("qwen2-1.5b", "qwen3-moe-235b-a22b")
HEADS = {"10-2": dict(n_heads=10, n_kv_heads=2, d_head=32),
         "6-2": dict(n_heads=6, n_kv_heads=2, d_head=32),
         "3-1": dict(n_heads=3, n_kv_heads=1, d_head=32)}
# each position's (query heads, kv heads) at model=4
RANGES = {"10-2": [(3, 1), (2, 1), (3, 1), (2, 1)],
          "6-2": [(2, 1), (1, 1), (2, 1), (1, 1)],
          "3-1": [(1, 1), (1, 1), (1, 1), (0, 0)]}
LOOP = ("qwen2-1.5b", "10-2")
B, S, N_NEW = 4, 32, 4
RTOL = ATOL = 1e-4
GRAD_L2 = 1e-4
DEADLINE = 240

REF = r'''
import dataclasses, pickle, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding
from repro.configs import get_config
from repro.launch.mesh import make_mesh_compat
from repro.models import get_model
from repro.sharding.partition import (batch_partition_specs, make_dist_ctx,
                                      named_shardings)

out = sys.argv[1]
mesh = make_mesh_compat((1, 4), ("data", "model"))
ctx = make_dist_ctx(mesh)
np_ = lambda t: jax.tree_util.tree_map(np.asarray, t)
greedy = lambda lg: jnp.argmax(lg[:, -1], axis=-1)[:, None].astype(jnp.int32)
res = {}
k = 0
for name in %(archs)r:
    for tag, heads in %(heads)r.items():
        k += 1
        base = dataclasses.replace(get_config(name, reduced=True), **heads)
        ops = get_model(base)
        params = ops.init_params(jax.random.PRNGKey(40 + k), base)
        rng = np.random.default_rng(50 + k)
        toks = rng.integers(0, base.vocab, (%(B)d, %(S)d + 1)).astype(
            np.int32)
        batch_np = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        r = {"params": np_(params), "batch": batch_np}
        p = jax.device_put(params, named_shardings(params, ctx))
        place = lambda b: jax.device_put(b, jax.tree_util.tree_map(
            lambda s: NamedSharding(mesh, s), batch_partition_specs(b, ctx),
            is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec)))
        batch = place(batch_np)
        loss, g = jax.jit(jax.value_and_grad(
            lambda q, b: ops.train_loss(q, b, base, ctx)))(p, batch)
        r["loss"], r["grads"] = float(loss), np_(g)
        for quant in (False, True):
            cfg = dataclasses.replace(base, kv_quant=quant)
            sv = place({"tokens": batch_np["tokens"]})
            logits, cache = jax.jit(
                lambda q, b: ops.prefill(q, b, cfg, ctx))(p, sv)
            s = {"logits": [np.asarray(logits)], "cache0": np_(cache)}
            toks_out = [greedy(logits)]
            dec = jax.jit(lambda q, c, t: ops.decode_step(q, c, t, cfg, ctx))
            for _ in range(%(n_new)d - 1):
                logits, cache = dec(p, cache, toks_out[-1])
                s["logits"].append(np.asarray(logits))
                toks_out.append(greedy(logits))
            s["tokens"] = np.asarray(jnp.concatenate(toks_out, axis=1))
            r[f"serve_{int(quant)}"] = s
        res[(name, tag)] = r
pickle.dump(res, open(f"{out}/ref.pkl", "wb"))
print("REF-OK")
''' % {"archs": ARCHS, "heads": HEADS, "B": B, "S": S, "n_new": N_NEW}

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
                        timeout=datetime.timedelta(seconds=200))
from repro_torch.configs import get_config
from repro_torch.core.arena import pack_arena
from repro_torch.core.policy import CheckpointPolicy
from repro_torch.data import ShardedLMDataset
from repro_torch.distributed import collectives
from repro_torch.fabric import FabricConfig
from repro_torch.interop import from_numpy_tree, to_numpy_tree
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import get_model
from repro_torch.sharding.partition import (make_dist_ctx, model_slices,
                                            state_slices)
from repro_torch.training import TrainLoop, TrainLoopConfig
from repro_torch.training.serve import Server
from repro_torch.training.step import loss_and_grad
from repro_torch.utils.tree import tree_flatten

collectives.CHUNK_BYTES = 1 << 16
mesh = make_host_mesh(model=4)
ctx = make_dist_ctx(mesh)
ref = pickle.load(open(f"{out}/ref.pkl", "rb"))
res = {"rank": rank, "pos": mesh.axis_position("model")}


def greedy(lg):
    return torch.argmax(lg[:, -1], dim=-1)[:, None].to(torch.int32)


for (name, tag), r in ref.items():
    base = dataclasses.replace(get_config(name, reduced=True),
                               **%(heads)r[tag])
    ops = get_model(base)
    whole = from_numpy_tree(r["params"], "cpu")
    batch = from_numpy_tree(r["batch"], "cpu")
    loss, g = loss_and_grad(ops, base, whole, batch, ctx)
    leaves = tree_flatten(g)[0]
    for x in leaves:
        dist.all_reduce(x)
    got = {"loss": float(loss)}
    if rank == 0:
        got["grads"] = to_numpy_tree(g)
    params = from_numpy_tree(r["params"], "cpu",
                             model_slices(r["params"], ctx))
    att = params["layers"]["attn"]
    got["heads"] = (att["wq"].shape[-2], att["wk"].shape[-2])
    for quant in (0, 1):
        cfg = dataclasses.replace(base, kv_quant=bool(quant))
        want = r[f"serve_{quant}"]
        with torch.no_grad():
            logits, cache = ops.prefill(params, {"tokens": batch["tokens"]},
                                        cfg, ctx)
            s = {"logits": [logits.numpy()], "cache0": to_numpy_tree(cache)}
            toks = [greedy(logits)]
            for _ in range(%(n_new)d - 1):
                logits, cache = ops.decode_step(params, cache, toks[-1], cfg,
                                                ctx)
                s["logits"].append(logits.numpy())
                toks.append(greedy(logits))
            s["tokens"] = torch.cat(toks, dim=1).numpy()
            s["server"] = Server(cfg, params, device="cpu", ctx=ctx).generate(
                {"tokens": batch["tokens"]}, %(n_new)d).numpy()
            if quant:
                # decode steps from the reference's own int8 cache, fed its
                # tokens: a value one count off moves a step's logits
                c = from_numpy_tree(want["cache0"], "cpu", state_slices(
                    want["cache0"], ctx, heads=cfg.n_heads))
                t = torch.from_numpy(want["tokens"].copy())
                s["on_ref_cache"] = []
                for i in range(%(n_new)d - 1):
                    lg, c = ops.decode_step(params, c, t[:, i:i + 1], cfg,
                                            ctx)
                    s["on_ref_cache"].append(lg.numpy())
        got[f"serve_{quant}"] = s
    if (name, tag) == %(loop)r:
        # the arena and PyTree loops on the mesh, per-layer leaves (wo held
        # 2-D, cut by rows): losses and the rank's span bit for bit
        runs = {}
        for arena in (True, False):
            lo = TrainLoop(base, None, TrainLoopConfig(
                policy=CheckpointPolicy.scar(fraction=0.25, interval=2),
                fabric=FabricConfig(n_devices=4, devices_per_host=2),
                arena_state=arena), device="cpu", ctx=ctx)
            st = lo.run(lo.init_state(params=r["params"]),
                        iter(ShardedLMDataset(base, 4, 32, device="cpu",
                                              ctx=ctx)), 2)
            runs[arena] = (lo, st)
        (la, sa), (lt, stt) = runs[True], runs[False]
        w0, w1 = sa.layout.span(mesh.position())
        got["loop"] = {
            "state": type(sa).__name__,
            "arena_losses": [m["loss"] for m in la.metrics],
            "pytree_losses": [m["loss"] for m in lt.metrics],
            "spans_equal": bool(torch.equal(
                sa.arena, pack_arena(stt.params, sa.layout)[w0:w1])),
            "wo_2d": tuple(stt.params["layers"][0]["attn"]["wo"].shape)}
    res[(name, tag)] = got
pickle.dump(res, open(f"{out}/rank_{rank}.pkl", "wb"))
dist.destroy_process_group()
''' % {"heads": HEADS, "n_new": N_NEW, "loop": LOOP}


def _reference(out: Path) -> dict:
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.run([sys.executable, "-c", REF, str(out)],
                          capture_output=True, text=True, timeout=DEADLINE,
                          env=env)
    assert proc.returncode == 0 and "REF-OK" in proc.stdout, (
        f"the reference's subprocess failed:\n{proc.stderr[-4000:]}")
    return pickle.load(open(out / "ref.pkl", "rb"))


def _ranks(out: Path, world: int = 4) -> list:
    (out / "rank.py").write_text(RANK)
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1",
               GLOO_SOCKET_IFNAME="lo")
    procs = [subprocess.Popen(
        [sys.executable, str(out / "rank.py"), str(r), str(world),
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


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's mesh run, then the port's 4 ranks on its draws."""
    out = tmp_path_factory.mktemp("uneven_heads")
    ref = _reference(out)
    return ref, _ranks(out)


def _cfg(name: str, tag: str):
    return dataclasses.replace(get_config(name, reduced=True), **HEADS[tag])


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


CASES = [(n, t) for n in ARCHS for t in HEADS]


@pytest.mark.parametrize("name,tag", CASES)
def test_train_loss_and_gradient_match_reference_mesh(runs, name, tag):
    ref, ranks = runs
    want = ref[(name, tag)]
    for r in ranks:
        got = r[(name, tag)]
        assert got["loss"] == pytest.approx(want["loss"], rel=1e-4)
        assert got["heads"] == RANGES[tag][r["pos"]]
    got = flatten_with_path(ranks[0][(name, tag)]["grads"])[0]
    exp = dict((keystr(p), x) for p, x in flatten_with_path(
        want["grads"])[0])
    assert len(got) == len(exp)
    for path, g in got:
        k = keystr(path)
        assert g.shape == exp[k].shape, k
        assert _rel_l2(g, exp[k]) <= GRAD_L2, (k, _rel_l2(g, exp[k]))


def _kv_cut(tree: dict, cfg, pos: int) -> dict:
    """The reference's whole cache cut to model position ``pos``'s state
    slice (its kv heads; ``pos`` of 4)."""
    class _StandIn:
        shape = {"data": 1, "model": 4}
        axis_names = ("data", "model")
        devices = np.arange(4).reshape(1, 4)
    ctx = tp.DistContext(mesh=_StandIn())
    return to_numpy_tree(from_numpy_tree(tree, "cpu", tp.state_slices(
        tree, ctx, pos=pos, data_pos=0, heads=cfg.n_heads)))


@pytest.mark.parametrize("quant", (0, 1), ids=("bf16_route", "kv_quant"))
@pytest.mark.parametrize("name,tag", CASES)
def test_serve_on_uneven_heads_matches_reference_mesh(runs, name, tag,
                                                      quant):
    ref, ranks = runs
    want = ref[(name, tag)][f"serve_{quant}"]
    cfg = _cfg(name, tag)
    for r in ranks:
        s = r[(name, tag)][f"serve_{quant}"]
        steps = s["logits"][:1] + s.get("on_ref_cache", s["logits"][1:])
        assert len(steps) == N_NEW
        for i, (g, w) in enumerate(zip(steps, want["logits"])):
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                       err_msg=f"rank {r['rank']} step {i}")
        np.testing.assert_array_equal(s["tokens"], want["tokens"])
        np.testing.assert_array_equal(s["server"], want["tokens"])
        cut = _kv_cut(want["cache0"], cfg, r["pos"])
        for (path, a), (_, b) in zip(flatten_with_path(s["cache0"])[0],
                                     flatten_with_path(cut)[0]):
            k = f"rank {r['rank']} {keystr(path)}"
            assert a.shape == b.shape and a.dtype == b.dtype, k
            if a.dtype == np.int8:
                assert a.size == 0 or np.abs(a.astype(np.int32)
                                             - b).max() <= 1, k
            elif np.issubdtype(a.dtype, np.integer):
                np.testing.assert_array_equal(a, b, err_msg=k)
            else:
                np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL,
                                           err_msg=k)
        assert s["cache0"]["k"].shape[3] == RANGES[tag][r["pos"]][1]


def test_arena_loop_is_the_pytree_loop_on_uneven_heads(runs):
    _, ranks = runs
    cfg = _cfg(*LOOP)
    first = ranks[0][LOOP]["loop"]["arena_losses"]
    for r in ranks:
        lp = r[LOOP]["loop"]
        assert lp["state"] == "ArenaTrainState"
        assert lp["arena_losses"] == lp["pytree_losses"] == first
        assert lp["spans_equal"]
        assert lp["wo_2d"] == (cfg.n_heads * cfg.head_dim, cfg.d_model)
    assert len(first) == 2 and all(np.isfinite(first))


# ---------------------------------------------------------------------------
# in process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tag", tuple(HEADS))
def test_model_and_state_slices_take_whole_head_ranges(tag):
    """Each position's ``wq``, ``bq``, ``wo`` (stacked and 2-D) and cache
    slices are its query heads' and kv heads', shapes only; the ranges
    tile the heads."""
    from repro_torch.launch.mesh import make_dry_mesh
    from repro_torch.models import get_model
    from repro_torch.models.layers import split_layers
    cfg = _cfg("qwen2-1.5b", tag)
    ops = get_model(cfg)
    whole = ops.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    split = split_layers(whole, ops.stacked_layers)
    cache = ops.init_cache(cfg, B, 16, device="cpu")
    Dh, seen = cfg.head_dim, 0
    for pos in range(4):
        ctx = tp.make_dist_ctx(make_dry_mesh((1, 4), ("data", "model"),
                                             position=pos))
        lo, hi = tp.query_head_range(cfg.n_heads, cfg.n_kv_heads, 4, pos)
        klo, khi = tp.kv_head_range(cfg.n_heads, cfg.n_kv_heads, 4, pos)
        assert (hi - lo, khi - klo) == RANGES[tag][pos]
        assert lo == seen
        seen = hi
        att = tp.model_slices(whole, ctx)["layers"]["attn"]
        assert tuple(att["wq"]) == (2, lo, hi)
        assert tuple(att["bq"]) == (1, lo, hi)
        assert tuple(att["wo"]) == (1, lo, hi)
        assert tuple(att["wk"]) == (2, klo, khi)
        att2 = tp.model_slices(split, ctx)["layers"][0]["attn"]
        assert tuple(att2["wo"]) == (0, lo * Dh, hi * Dh)
        sl = tp.state_slices(cache, ctx, heads=cfg.n_heads)
        assert tuple(sl["k"][-1]) == (3, klo, khi)
        mine = ops.init_cache(cfg, B, 16, device="cpu", ctx=ctx)
        assert mine["k"].shape[3] == khi - klo
    assert seen == cfg.n_heads
