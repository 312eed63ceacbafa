"""The mesh train step that gathers each layer's model slices only while
the layer runs and sends its gradient as the backward leaves it
(``sharding.partition.SlicePlan``'s groups, ``models.layers.layer_call``,
``training.step``), against the step that gathered every slice of the
rank for the whole step and the reference's parameters.

In process, on the reference's initial parameters (``init_params`` of the
reduced configs, as numpy), per-layer leaves and the reference's stacked
ones:

- the seven families on ``(2, 2)`` and ``(1, 4)``, qwen2-1.5b on ``(1,
  8)`` (uneven query heads) and the stacked partition (qwen2-1.5b and the
  interleaved llama4-maverick): the groups' boxes cover each position's
  slices exactly once, the groups' values sum to the slices'; each group
  gathered from the owners' spans decodes bit for bit to its leaves'
  ``take_model_slices`` (a stacked leaf's row of its layer), and the
  model's tree of them is the sliced tree's; zamba2's shared block and
  whisper's encoder are in the outer group;
- on meta, rank 0 and rank 17 of the dry ``(16, 16)`` mesh running
  llama4-maverick at full width and four layers: the step's peak falls
  below the whole-slice step's by at least the slices' bytes less two
  layers', and no storage the step makes holds the rank's slice values.

gloo jobs (one torch thread a rank, a deadline a job, as
``tests/test_torch_mesh_slice_step.py``, at a lower CPU priority):
reduced qwen2-1.5b on ``(2, 2)`` and ``(1, 4)``, reduced llama4-maverick
(a dense and an MoE layer, bf16 moments) on ``(1, 4)``, reduced
zamba2-1.2b on ``(1, 2)`` and on the survivor mesh ``(2, 1)``; 3 adamw
steps. At microbatch 1 the span, both moments and the losses
``torch.equal`` (f32 values) the whole-slice step written here (the step
this one replaced: every slice of the rank gathered once, the gradient of
all of them reduced once); at microbatch 2 they ``torch.equal`` a
whole-slice route that sums in the reference's order (each microbatch's
gradient reduced, divided by the shards and added into the span's
accumulator, divided by the microbatches), and lie within rtol 1e-6 of
the replaced step's order (microbatches added on the rank first), or,
with bf16 moments, within one bf16 rounding (rtol 1e-2). The PyTree step
on the same mesh gives the arena step's bits. The microbatched step
against the reference's own mesh step:
``tests/test_torch_mesh_microbatch_reference.py``.
"""
import dataclasses
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
import torch

from repro.configs import get_config as j_get_config
from repro.models import get_model as j_get_model
from repro_torch.configs import get_config
from repro_torch.core.arena import build_arena_layout, pack_arena, unpack_arena
from repro_torch.core.blocks import partition_pytree
from repro_torch.interop import from_numpy_tree
from repro_torch.launch.mesh import make_dry_mesh, make_dry_production_mesh
from repro_torch.models import get_model
from repro_torch.models.layers import split_layers
from repro_torch.sharding.partition import (OUTER, SlicePlan, make_dist_ctx,
                                            model_slices, take_model_slices)
from repro_torch.utils.tree import (flatten_with_path, keystr, tree_flatten,
                                    tree_leaves, tree_unflatten)

SRC = Path(__file__).resolve().parents[1] / "src"
# a job's wall: a loaded host stretches a job 2-3x (the ranks' gloo
# timeout, 120 s a collective, fails a hung one first)
DEADLINE = 300
# the gloo ranks yield the CPU to the tests that share the host
NICE = ("nice", "-n", "10")
FAMILIES = ("qwen2-1.5b", "qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b",
            "internvl2-76b", "mamba2-370m", "zamba2-1.2b", "whisper-medium")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference_params(name: str, seed: int = 0):
    jcfg = j_get_config(name, reduced=True)
    params = j_get_model(jcfg).init_params(jax.random.PRNGKey(seed), jcfg)
    return jax.tree_util.tree_map(np.asarray, params)


def _layout(name: str, shards: int, per_layer: bool = True):
    cfg = get_config(name, reduced=True)
    params = from_numpy_tree(_reference_params(name), "cpu")
    leaves, treedef = tree_flatten(params)
    params = tree_unflatten(treedef, [x.to(torch.float32) for x in leaves])
    if per_layer:
        params = split_layers(params, get_model(cfg).stacked_layers)
    return cfg, params, build_arena_layout(
        partition_pytree(params, block_rows=8), shards=shards)


CASES = [(f, shape, True) for f in FAMILIES for shape in ((2, 2), (1, 4))] \
    + [("qwen2-1.5b", (1, 8), True), ("qwen2-1.5b", (2, 2), False),
       ("llama4-maverick-400b-a17b", (1, 4), False)]


@pytest.mark.parametrize(
    "name,shape,per_layer", CASES,
    ids=[f"{n}-{s[0]}x{s[1]}-{'layers' if p else 'stacked'}"
         for n, s, p in CASES])
def test_groups_cover_the_slices_and_decode_to_each_layer(name, shape,
                                                          per_layer):
    n = int(np.prod(shape))
    cfg, params, layout = _layout(name, n, per_layer)
    ops = get_model(cfg)
    arena = pack_arena(params, layout)
    whole = unpack_arena(arena, layout)
    wleaves = tree_leaves(whole)
    sw = layout.shard_words
    names = [keystr(p) for p, _ in flatten_with_path(whole)[0]]
    seen_m = set()
    for p in range(n):
        mesh = make_dry_mesh(shape, ("data", "model"), position=p)
        ctx = make_dist_ctx(mesh)
        plan = SlicePlan(layout, mesh, ctx, ops.remat_layers)
        whole_plan = SlicePlan(layout, mesh, ctx)
        m = plan.model
        if m in seen_m:
            continue
        seen_m.add(m)
        assert plan.n_groups == 1 + cfg.n_layers
        # every leaf in exactly one group; each group's values add up to
        # the slices'
        held = sorted((li, row) for g in range(plan.n_groups)
                      for li, row in plan.entries[g])
        rows = [(li, r) for li, r in held if r is not None]
        assert len({li for li, _ in held}) == len(wleaves)
        assert len(held) == len(set(held))
        assert whole_plan.n_groups == 1
        assert sum(plan.group_values(g, m) for g in range(plan.n_groups)) \
            == whole_plan.group_values(OUTER, m)
        if not per_layer:
            assert len(rows) > 0
        # the outer group: the embedding and head, zamba2's shared block,
        # whisper's encoder; no layer group holds them
        outer = {names[li] for li, _ in plan.entries[OUTER]}
        for key in ("['shared']", "['enc_layers']"):
            hit = [x for x in names if x.startswith(key)]
            assert set(hit) <= outer
            if name in ("zamba2-1.2b", "whisper-medium") \
                    and key == ("['shared']" if name == "zamba2-1.2b"
                                else "['enc_layers']"):
                assert hit
        want = take_model_slices(whole, model_slices(whole, ctx))
        wl = tree_leaves(want)
        cover = torch.zeros((n * sw,), dtype=torch.int32)
        bufs = {}
        for g in range(plan.n_groups):
            buf = torch.zeros((plan.group_values(g, m),), dtype=torch.int32)
            hits = torch.zeros_like(buf)
            for q in range(n):
                span = arena[q * sw:(q + 1) * sw]
                for b in plan.gather_boxes(q, m, g):
                    b.slice_view(buf).copy_(b.arena_view(span, q * sw))
                    b.slice_view(hits).add_(1)
                    b.arena_view(cover, 0).add_(1)
            assert torch.equal(hits, torch.ones_like(hits)), g
            got = plan.decode(buf.view(torch.float32), g)
            for (li, row), x in zip(plan.entries[g], got):
                w = wl[li] if row is None else wl[li][row]
                assert x.shape == w.shape and torch.equal(x, w), (g, li)
            bufs[g] = buf.view(torch.float32)
        # each word at most once over the groups: the slices' words
        assert int(cover.max()) == 1
        assert int(cover.sum()) == sum(
            b.numel for q in range(n)
            for b in whole_plan.gather_boxes(q, m, OUTER))
        # the tree the model runs: the sliced tree, stacked subtrees as
        # the lists of their layers
        tree = plan.model_tree(plan.decode(bufs[OUTER], OUTER),
                               lambda g: tree_unflatten(
                                   plan.group_treedefs[g],
                                   plan.decode(bufs[g], g)))
        if per_layer:
            got = tree_leaves(tree)
            assert len(got) == len(wl)
            assert all(torch.equal(a, b) for a, b in zip(got, wl))
        else:
            key = ops.remat_layers[0][0]
            assert isinstance(tree[key], list) \
                and len(tree[key]) == len(tree_leaves(want[key])[0])


def _stand_in_step(name: str, layers: int, pos: int, route: str):
    """The dry (16, 16) mesh's rank ``pos`` running ``name`` at full width
    and ``layers`` layers on meta (a sequence of 128 tokens a microbatch
    and data position), by the step of
    ``route`` (``"layers"``: this package's; ``"whole"``: the
    whole-slice step of :data:`ROUTES`)."""
    from repro_torch.launch import dryrun
    cfg = dataclasses.replace(get_config(name), n_layers=layers)
    mesh = make_dry_production_mesh()
    if pos:
        mesh = make_dry_mesh((16, 16), ("data", "model"), position=pos)
    step = dryrun.build_rank_step(cfg, "train", 16 * cfg.microbatch, 128,
                                  mesh, "meta")
    if route == "whole":
        env = {}
        exec(ROUTES, env)
        info = step.info
        (arena, mu, nu), batch = step.args["state"], step.args["batch"]
        from repro_torch.models.layers import torch_dtype
        from repro_torch.optim.optimizers import OptState, adamw
        from repro_torch.training.train_state import ArenaTrainState
        layout = info["slice_plan"].layout
        cfg = info["cfg"]
        opt = adamw(3e-4, moment_dtype=torch_dtype(cfg.opt_moment_dtype))
        whole = env["whole_slice_step"](get_model(cfg), cfg, opt, layout,
                                        mesh.comm(), info["ctx"])
        t0 = ArenaTrainState.create(arena, opt, layout).opt_state.step
        state = ArenaTrainState(arena, OptState(t0, mu, nu), 0, layout)
        step = dryrun.RankStep(lambda: whole(state, batch), step.args, info)
    return step


@pytest.mark.parametrize("pos", (0, 17))
def test_layer_step_holds_one_layer_of_slices_on_meta(pos):
    """llama4-maverick at full width, two dense + MoE pairs, rank ``pos``
    of the dry (16, 16) mesh: the peak of the bytes the step allocates is
    below the whole-slice step's by at least the slices' bytes less two
    layers' (the whole-slice step holds the slices and their gradient;
    this one the outer group and one layer), and no storage it makes
    holds as many bytes as the rank's slice values."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten as pt_flatten
    from repro_torch.launch import dryrun

    class Largest(TorchDispatchMode):
        most = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for x in pt_flatten(out)[0]:
                if isinstance(x, torch.Tensor):
                    self.most = max(self.most,
                                    x.untyped_storage().nbytes())
            return out
    name = "llama4-maverick-400b-a17b"
    new = _stand_in_step(name, 4, pos, "layers")
    plan = new.info["slice_plan"]
    m = plan.model
    assert plan.n_groups == 5
    layer_max = max(plan.group_values(g, m) for g in range(1, 5))
    values = sum(plan.group_values(g, m) for g in range(5))
    with Largest() as mode:
        got = dryrun.measure(new)
    assert 0 < mode.most < 4 * values
    assert mode.most >= 4 * layer_max
    old = dryrun.measure(_stand_in_step(name, 4, pos, "whole"))
    drop = old["memory"]["temp_bytes"] - got["memory"]["temp_bytes"]
    assert drop >= 4 * (values - 2 * layer_max) > 0, (
        old["memory"], got["memory"])
    assert got["memory"]["argument_bytes"] == old["memory"]["argument_bytes"]


@pytest.mark.parametrize("name", FAMILIES)
def test_one_rank_mesh_layer_step_is_the_whole_slice_step(name):
    """Every family on a one-rank mesh (no process group: each exchange a
    copy), 2 adamw steps: at microbatch 1 the span, both moments and the
    losses ``torch.equal`` the whole-slice step (:data:`ROUTES`), at
    microbatch 2 its reference-order route; the gather and reduce calls
    the groups'. The layers' gradients go through their gather nodes in
    the graph the whole-slice step's remat builds, so the input gradients
    (whisper's encoder output's too) are summed as there."""
    from repro_torch.data import ShardedLMDataset
    from repro_torch.distributed import collectives
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.layers import torch_dtype
    from repro_torch.optim import adamw
    from repro_torch.training.step import make_arena_train_step
    from repro_torch.training.train_state import ArenaTrainState
    env = {}
    exec(ROUTES, env)
    mesh = make_host_mesh()
    ctx = make_dist_ctx(mesh)
    comm = mesh.comm()
    _, params, layout = _layout(name, 1)
    arena = pack_arena(params, layout)
    for mb in (1, 2):
        cfg = dataclasses.replace(get_config(name, reduced=True),
                                  dtype="float32", microbatch=mb)
        ops = get_model(cfg)
        ds = ShardedLMDataset(cfg, 2, 16, seed=3, device="cpu", ctx=ctx)
        batches = [ds.next_batch() for _ in range(2)]
        opt = adamw(3e-3, moment_dtype=torch_dtype(cfg.opt_moment_dtype))
        got = []
        for route in ("layers", "replaced" if mb == 1 else "reference"):
            state = ArenaTrainState.create(arena.clone(), opt, layout)
            step = (make_arena_train_step(ops, cfg, opt, layout, comm, ctx)
                    if route == "layers" else env["whole_slice_step"](
                        ops, cfg, opt, layout, comm, ctx, order=route))
            collectives.reset_stats()
            losses = []
            for b in batches:
                state, loss = step(state, b)
                losses.append(float(loss))
            got.append((losses, state.arena, state.opt_state.mu,
                        state.opt_state.nu))
            if route == "layers":
                n = step.plan.n_groups - 1
                st = collectives.seconds_and_bytes()
                assert n == cfg.n_layers
                assert st["slice_gather"]["calls"] == 2 * (1 + 2 * mb * n)
                assert st["slice_reduce"]["calls"] == 2 * mb * (1 + n)
        (s, *a), (w, *b) = got
        assert s == w and all(np.isfinite(s))
        for x, y in zip(a, b):
            assert torch.equal(x, y), mb


# the whole-slice routes: the step this one replaced, and the same route
# summing microbatches in the reference's order (exec'd here and in the
# rank script)
ROUTES = r'''
import torch
from repro_torch.models.layers import torch_dtype
from repro_torch.optim.optimizers import arena_apply
from repro_torch.sharding.partition import OUTER, SlicePlan
from repro_torch.training.step import _mean_loss, _mesh_terms, _microbatches
from repro_torch.training.train_state import ArenaTrainState
from repro_torch.utils.tree import tree_unflatten


def slice_grads(ops, cfg, treedef, params, batch, tp_ctx):
    """The loss of ``batch`` on the rank's slices ``params`` (a list in
    leaf order of the tree ``treedef``) and their gradient, a list (zeros
    where the loss does not reach a leaf)."""
    leaves = [x.detach().requires_grad_(True) for x in params]
    kw = {} if tp_ctx is None else {"ctx": tp_ctx}
    with torch.enable_grad():
        loss = ops.train_loss(tree_unflatten(treedef, leaves), batch, cfg,
                              **kw)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), [torch.zeros_like(x) if g is None else g
                           for x, g in zip(leaves, grads)]


def whole_slice_step(ops, cfg, optimizer, layout, comm, ctx,
                     order="replaced"):
    """Every slice of the rank gathered once for the step (a plan with
    no layer groups: :data:`OUTER` holds every leaf), the gradient of
    all of them taken at once and reduced once. Microbatched: ``order``
    "replaced" adds the microbatches' gradients on the rank into a
    slice-sized accumulator in ``cfg.opt_moment_dtype``, divides it by
    them and reduces it, then divides by the shards;
    "reference" reduces each microbatch's, divides it by the shards and
    adds it into a span accumulator in that dtype (in f32, rounded),
    which it divides by the microbatches."""
    tp_ctx, shards = _mesh_terms(cfg, comm, ctx)
    plan = SlicePlan(layout, comm.mesh, tp_ctx)
    f32 = torch.float32
    dt = torch_dtype(cfg.opt_moment_dtype)

    def reduce_all(g):
        return comm.slice_reduce(plan.pack(torch.empty(
            (plan.group_values(OUTER),), dtype=f32, device=g[0].device), g,
            OUTER), plan, OUTER)

    def step(state, batch):
        buf = comm.slice_gather(state.arena, plan, OUTER)
        params = plan.decode(buf.view(f32), OUTER)
        mb = max(cfg.microbatch, 1)
        if mb == 1:
            loss, g = slice_grads(ops, cfg, plan.treedef, params, batch,
                                  tp_ctx)
            del params, buf
            span = reduce_all(g)
            if shards > 1:
                span.div_(shards)
        elif order == "replaced":
            acc = torch.zeros((plan.group_values(OUTER),), dtype=dt,
                              device=buf.device)
            loss = 0.0
            for bx in _microbatches(batch, mb):
                l, g = slice_grads(ops, cfg, plan.treedef, params, bx,
                                   tp_ctx)
                for y, x in zip(plan.decode(acc, OUTER), g):
                    if dt == f32:
                        y.add_(x)
                    else:
                        y.copy_(y.to(f32) + x.to(f32))
                del g
                loss = loss + l
            del params, buf
            acc.div_(mb)
            span = comm.slice_reduce(acc, plan, OUTER)
            if shards > 1:
                span.div_(shards)
            loss = loss / mb
        else:
            span = torch.zeros((plan.shard_words,), dtype=dt,
                               device=buf.device)
            loss = 0.0
            for bx in _microbatches(batch, mb):
                l, g = slice_grads(ops, cfg, plan.treedef, params, bx,
                                   tp_ctx)
                part = reduce_all(g)
                if shards > 1:
                    part.div_(shards)
                if dt == f32:
                    span.add_(part)
                else:
                    span.copy_(span.to(f32) + part)
                loss = loss + l
            del params, buf
            span.div_(mb)
            loss = loss / mb
        loss = _mean_loss(loss, comm, tp_ctx, shards)
        arena, opt = arena_apply(optimizer, span, state.opt_state,
                                 state.arena, layout,
                                 runs=layout.span_runs(comm.pos))
        return ArenaTrainState(arena, opt, state.step + 1,
                               state.layout), loss
    return step
'''

RANK_SCRIPT = r'''
import datetime, json, pickle, sys
import torch
import torch.distributed as dist

torch.set_num_threads(1)
rank, world, rdv, out = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                         sys.argv[4])
dist.init_process_group("gloo", init_method=f"file://{rdv}", rank=rank,
                        world_size=world,
                        timeout=datetime.timedelta(seconds=120))
import dataclasses
from repro_torch.configs import get_config
from repro_torch.core.arena import build_arena_layout, pack_arena
from repro_torch.core.blocks import partition_pytree
from repro_torch.data import ShardedLMDataset
from repro_torch.distributed import collectives
from repro_torch.interop import from_numpy_tree
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import get_model
from repro_torch.models.layers import split_layers
from repro_torch.optim import adamw
from repro_torch.models.layers import torch_dtype
from repro_torch.sharding.partition import make_dist_ctx
from repro_torch.training.step import make_arena_train_step, make_train_step
from repro_torch.training.train_state import ArenaTrainState, TrainState
from repro_torch.utils.tree import tree_flatten, tree_unflatten

collectives.CHUNK_BYTES = 1 << 16
STEPS = 3
cases = pickle.load(open(f"{out}/cases.pkl", "rb"))
env = {}
exec(open(f"{out}/routes.py").read(), env)
whole_slice_step = env["whole_slice_step"]
import repro_torch.training.step as step_module
first_grads = []


def recording(apply):
    """``arena_apply`` that keeps a copy of the first gradient it gets."""
    def call(optimizer, grads, *a, **k):
        if not first_grads:
            first_grads.append(grads.to(torch.float32, copy=True))
        return apply(optimizer, grads, *a, **k)
    return call


step_module.arena_apply = recording(step_module.arena_apply)
env["arena_apply"] = recording(env["arena_apply"])


def rel(a, b):
    a, b = a.to(torch.float64), b.to(torch.float64)
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


res = {"rank": rank}
for name, model, np_params in cases:
    mesh = make_host_mesh(model=model)
    ctx = make_dist_ctx(mesh)
    comm = mesh.comm()
    pos = mesh.position()
    for mb in (1, 2):
        cfg = dataclasses.replace(get_config(name, reduced=True),
                                  dtype="float32", microbatch=mb)
        ops = get_model(cfg)
        params = from_numpy_tree(np_params, "cpu")
        params = tree_unflatten(tree_flatten(params)[1], [
            x.to(torch.float32) for x in tree_flatten(params)[0]])
        params = split_layers(params, ops.stacked_layers)
        layout = build_arena_layout(partition_pytree(params, block_rows=8),
                                    shards=world)
        w0, w1 = layout.span(pos)
        arena = pack_arena(params, layout)
        ds = ShardedLMDataset(cfg, 2 * (world // model), 16, seed=3,
                              device="cpu", ctx=ctx)
        batches = [ds.next_batch() for _ in range(STEPS)]
        opt = adamw(3e-3, moment_dtype=torch_dtype(cfg.opt_moment_dtype))
        routes = ("layers", "replaced") + (("reference",) if mb > 1 else ())
        got = {}
        for route in routes:
            state = ArenaTrainState.create(arena[w0:w1].clone(), opt, layout)
            if route == "layers":
                step = make_arena_train_step(ops, cfg, opt, layout, comm, ctx)
            else:
                step = whole_slice_step(ops, cfg, opt, layout, comm, ctx,
                                        order=route)
            collectives.reset_stats()
            first_grads.clear()
            losses = []
            for b in batches:
                state, loss = step(state, b)
                losses.append(float(loss))
            got[route] = (losses, state.arena.view(torch.float32),
                          state.opt_state.mu, state.opt_state.nu,
                          first_grads[0])
            if route == "layers":
                st = collectives.seconds_and_bytes()
                plan = step.plan
        tree = TrainState.create(params, opt)
        tstep = make_train_step(ops, cfg, opt, layout, comm, ctx)
        for b in batches:
            tree, loss = tstep(tree, b)
        tspan = pack_arena(tree.params, layout)[w0:w1].view(torch.float32)
        s = got["layers"]
        yard = got["reference" if mb > 1 else "replaced"]
        r = got["replaced"]
        res[f"{name}/{model}/{mb}"] = {
            "losses": [s[0], yard[0], r[0]],
            "equal": [bool(torch.equal(a, b)) for a, b in zip(s[1:],
                                                             yard[1:])],
            "replaced_rel": [rel(a, b) for a, b in zip(s[1:4], r[1:4])],
            "grad_rel": rel(s[4], r[4]),
            "pytree_equal": bool(torch.equal(tspan, s[1])),
            "finite": bool(torch.isfinite(s[1]).all()),
            "groups": plan.n_groups,
            "moments": cfg.opt_moment_dtype,
            "gather_calls": st["slice_gather"]["calls"],
            "reduce_calls": st["slice_reduce"]["calls"]}
json.dump(res, open(f"{out}/rank_{rank}.json", "w"))
dist.destroy_process_group()
'''


def _job(tmp_path: Path, world: int, cases: list) -> list:
    """Run the rank script's cases on ``world`` gloo ranks; their reports,
    in rank order. Fails when a rank fails or the ranks outlive
    ``DEADLINE``."""
    (tmp_path / "rank.py").write_text(RANK_SCRIPT)
    (tmp_path / "routes.py").write_text(ROUTES)
    with open(tmp_path / "cases.pkl", "wb") as f:
        pickle.dump([(n, m, _reference_params(n)) for n, m in cases], f)
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1",
               GLOO_SOCKET_IFNAME="lo")
    procs = [subprocess.Popen(
        [*NICE, sys.executable, str(tmp_path / "rank.py"), str(r),
         str(world), str(tmp_path / "rdv"), str(tmp_path)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    end = time.monotonic() + DEADLINE
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(1.0, end - time.monotonic()))
            logs.append(out)
    except subprocess.TimeoutExpired:
        pytest.fail(f"the ranks did not finish in {DEADLINE} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
    return [json.loads((tmp_path / f"rank_{r}.json").read_text())
            for r in range(world)]


JOBS = {4: [("qwen2-1.5b", 2), ("qwen2-1.5b", 4),
            ("llama4-maverick-400b-a17b", 4)],
        2: [("zamba2-1.2b", 2), ("zamba2-1.2b", 1)]}


@pytest.fixture(scope="module")
def gloo_jobs(tmp_path_factory):
    return {world: _job(tmp_path_factory.mktemp(f"layer_gather_{world}"),
                        world, cases) for world, cases in JOBS.items()}


GLOO_CASES = [(w, n, m, mb) for w, cases in JOBS.items() for n, m in cases
              for mb in (1, 2)]


@pytest.mark.parametrize("world,name,model,mb", GLOO_CASES,
                         ids=[f"{n}-{w // m}x{m}-mb{mb}"
                              for w, n, m, mb in GLOO_CASES])
def test_layer_step_is_the_whole_slice_step_bit_for_bit(gloo_jobs, world,
                                                        name, model, mb):
    ranks = gloo_jobs[world]
    key = f"{name}/{model}/{mb}"
    # the replaced order's gaps: the first step's gradient, then the span
    # and moments after three steps (adam turns a gradient's last bits
    # into whole updates where it is near zero: reported, ``-s``)
    print(f"{name} {world // model}x{model} mb{mb}: the replaced order's "
          f"max relative gaps {[r[key]['grad_rel'] for r in ranks]}, "
          f"{[r[key]['replaced_rel'] for r in ranks]}")
    cfg = get_config(name, reduced=True)
    tol = 1e-6 if ranks[0][key]["moments"] == "float32" else 1e-2
    for r in ranks:
        got = r[key]
        s, yard, replaced = got["losses"]
        assert s == yard, r["rank"]
        assert s == ranks[0][key]["losses"][0]
        assert np.allclose(s, replaced, rtol=tol, atol=0)
        assert all(np.isfinite(s)) and got["finite"]
        assert got["equal"] == [True] * 4, got["equal"]
        assert got["pytree_equal"]
        if mb == 1:
            assert max(got["replaced_rel"]) == got["grad_rel"] == 0.0
        else:
            assert got["grad_rel"] <= tol
        # the outer group once a step, each layer in each microbatch's
        # forward and recompute; a reduce a group and microbatch
        n = got["groups"] - 1
        assert n == cfg.n_layers
        assert got["gather_calls"] == 3 * (1 + 2 * mb * n)
        assert got["reduce_calls"] == 3 * mb * (1 + n)
