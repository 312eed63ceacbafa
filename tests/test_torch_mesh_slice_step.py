"""The mesh train step on the rank's model slices
(``sharding.partition.SlicePlan``, ``MeshComm.slice_gather`` and
``slice_reduce``) against the reference's parameters and the whole-arena
step it replaces.

In process, on the reference's initial parameters (``init_params`` of the
reduced configs, as numpy), per-layer leaves and the reference's stacked
ones:

- the seven families on ``(2, 2)`` and ``(1, 4)``, qwen2-1.5b on ``(1,
  8)`` (uneven query heads, a position with none) and the stacked
  partition: the words the plan gathers from every owner's span decode,
  leaf by leaf, bit for bit to ``take_model_slices(unpack_arena(arena))``;
  its boxes cover each position's slices exactly once, the words a mask of
  each slice (cut range by range with ``narrow``) packs to; each word's
  contributors to the reduce are every data position and the model
  positions whose slice covers it, a leaf computed whole counting at model
  position 0 alone, but the norms of the stacks' carry at every position
  (each rank applies them to its piece of a sequence-parallel carry);
- at the dry ``(16, 16)`` mesh, granite-8b's and yi-9b's slice values at
  model position 0 equal the sum of their slices' sizes;
- the step on a dry ``(2, 2)`` and ``(1, 4)`` mesh allocates no buffer of
  the whole arena's bytes.

gloo jobs (one torch thread a rank, a deadline a job, as
``tests/test_torch_mesh_spmd.py``, at a lower CPU priority): reduced qwen2-1.5b
on ``(2, 2)`` and ``(1, 4)`` (a shared kv head), reduced qwen3-moe on ``(1,
4)`` and reduced mamba2-370m on ``(1, 2)``, 3 adamw steps at microbatch 1 and
2: the span, both moments and the losses of the slice step ``torch.equal`` (f32
values) to the whole-arena route written here (the arena all-gathered, the
gradient of the whole leaves packed and reduce-scattered; at microbatch 2 in
the reference's order, a reduce a microbatch); the PyTree step on the same mesh
the same bits; the gathered bytes 4 B a slice value, the outer group's once a
step and each layer's twice a microbatch. Dropping a position's +0.0 part can
change only the sign of a zero sum: the jobs report the words whose sign bit
differs (``signed_zeros``).
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
from repro_torch.sharding.partition import (OUTER, SlicePlan,
                                            acts_on_pieces, make_dist_ctx,
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


def _layout(name: str, shards: int, per_layer: bool = True,
            block_rows: int = 8):
    cfg = get_config(name, reduced=True)
    params = _f32(from_numpy_tree(_reference_params(name), "cpu"))
    if per_layer:
        params = split_layers(params, get_model(cfg).stacked_layers)
    layout = build_arena_layout(partition_pytree(params,
                                                 block_rows=block_rows),
                                shards=shards)
    return params, layout


def _f32(tree):
    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [x.to(torch.float32) for x in leaves])


def _slice_masks(layout, ctx, m: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Two word masks of the arena: the words model position ``m``'s
    slices cover, and those of them that a position other than 0
    contributes to: a cut leaf's (not computed whole), and a norm's of a
    stack's carry (each rank's part of its sum)."""
    part = layout.partition
    shapes = tree_unflatten(part.treedef, [torch.empty(l.shape)
                                           for l in part.leaves])
    cuts = tree_leaves(model_slices(shapes, ctx, pos=m))
    norms = [acts_on_pieces(keystr(path))
             for path, _ in flatten_with_path(shapes)[0]]
    cover, cut = [], []
    for leaf, s, norm in zip(part.leaves, cuts, norms):
        mask = torch.zeros(leaf.shape)
        if s:
            for lo, hi in s.ranges:
                mask.narrow(s[0], lo, hi - lo).fill_(1.0)
        else:
            mask.fill_(1.0)
        cover.append(mask)
        cut.append(mask if s or norm else torch.zeros(leaf.shape))
    return tuple(pack_arena(tree_unflatten(part.treedef, x), layout)
                 .view(torch.float32) for x in (cover, cut))


CASES = [(f, shape, True) for f in FAMILIES for shape in ((2, 2), (1, 4))] \
    + [("qwen2-1.5b", (1, 8), True), ("qwen2-1.5b", (2, 2), False)]


@pytest.mark.parametrize("name,shape,per_layer", CASES,
                         ids=[f"{n}-{s[0]}x{s[1]}-{'layers' if p else 'stacked'}"
                              for n, s, p in CASES])
def test_plan_gathers_reduces_and_covers_the_slices(name, shape, per_layer):
    n = int(np.prod(shape))
    params, layout = _layout(name, n, per_layer)
    arena = pack_arena(params, layout)
    whole = unpack_arena(arena, layout)
    sw = layout.shard_words
    plans = [SlicePlan(layout, mesh, make_dist_ctx(mesh)) for mesh in (
        make_dry_mesh(shape, ("data", "model"), position=p)
        for p in range(n))]
    masks = {}
    for p, plan in enumerate(plans):
        ctx = make_dist_ctx(make_dry_mesh(shape, ("data", "model"), p))
        m = plan.model
        assert m == p % shape[1] and plan.tp == shape[1]
        if m not in masks:
            masks[m] = _slice_masks(layout, ctx, m)
        buf = torch.zeros((plan.group_values(OUTER, m),), dtype=torch.int32)
        hits = torch.zeros_like(buf)
        for q in range(n):
            span = arena[q * sw:(q + 1) * sw]
            seen = torch.zeros((sw,))
            for b in plan.gather_boxes(q, m, OUTER):
                b.slice_view(buf).copy_(b.arena_view(span, q * sw))
                b.slice_view(hits).add_(1)
                b.arena_view(seen, q * sw).add_(1.0)
            assert torch.equal(seen, masks[m][0][q * sw:(q + 1) * sw]), q
        assert torch.equal(hits, torch.ones_like(hits))
        want = tree_leaves(take_model_slices(whole, model_slices(whole,
                                                                 ctx)))
        got = plan.decode(buf.view(torch.float32), OUTER)
        assert len(got) == len(want)
        for i, (g, w) in enumerate(zip(got, want)):
            assert g.shape == w.shape and torch.equal(g, w), i
        assert plan.group_values(OUTER, m) == sum(w.numel() for w in want)
    # each owner's reduce: every data position, and the model positions
    # whose slice covers the word (a whole leaf at model position 0 alone,
    # but a norm of the carry at every position)
    for q in range(n):
        plan = plans[q]
        for p in range(n):
            m = plans[p].model
            got = torch.zeros((sw,))
            for b in plan.reduce_boxes(q, m, OUTER):
                b.arena_view(got, q * sw).add_(1.0)
            cover, cut = masks[m]
            want = (cover if m == 0 else cut)[q * sw:(q + 1) * sw]
            assert torch.equal(got, want), (q, p)


@pytest.mark.parametrize("name,values", (("granite-8b", 535_072_768),
                                         ("yi-9b", 589_959_168)))
def test_production_mesh_slice_values(name, values):
    """Rank 0 of the dry (16, 16) mesh: the plan's slice values, the sum
    of its slices' sizes, against the whole model's."""
    from repro_torch.launch.dryrun import meta_params
    cfg = dataclasses.replace(get_config(name), dtype="float32")
    whole = split_layers(meta_params(cfg), get_model(cfg).stacked_layers)
    layout = build_arena_layout(partition_pytree(whole, block_rows=128),
                                shards=256)
    mesh = make_dry_production_mesh()
    ctx = make_dist_ctx(mesh)
    plan = SlicePlan(layout, mesh, ctx)
    sizes = sum(x.numel() for x in tree_leaves(
        take_model_slices(whole, model_slices(whole, ctx))))
    assert plan.group_values(OUTER) == sizes == values
    assert sum(x.numel() for x in tree_leaves(whole)) > 14 * values


@pytest.mark.parametrize("shape", ((2, 2), (1, 4)))
def test_step_allocates_no_whole_arena_buffer(shape):
    """The arena step of a dry mesh's rank on meta: no storage it makes
    holds as many bytes as the whole arena (the PyTree step's whole tree
    and a one-position model axis are not held to it)."""
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
    cfg = get_config("qwen2-1.5b", reduced=True)
    step = dryrun.build_rank_step(cfg, "train", 4, 32, make_dry_mesh(
        shape, ("data", "model"), position=1), "meta")
    with Largest() as mode:
        step.run()
    words = step.info["arena_words"]
    assert 0 < mode.most < 4 * words


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
from repro_torch.core.arena import (accumulate_values, build_arena_layout,
                                    pack_arena, pack_values, unpack_arena)
from repro_torch.core.blocks import partition_pytree
from repro_torch.data import ShardedLMDataset
from repro_torch.distributed import collectives
from repro_torch.interop import from_numpy_tree
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import get_model
from repro_torch.models.layers import split_layers
from repro_torch.optim import adamw
from repro_torch.optim.optimizers import arena_apply
from repro_torch.sharding.partition import SlicePlan, make_dist_ctx
from repro_torch.training.step import (_grad_leaves, _mean_loss,
                                       _mesh_terms, _microbatches,
                                       loss_and_grad, make_arena_train_step,
                                       make_train_step)
from repro_torch.training.train_state import ArenaTrainState, TrainState
from repro_torch.utils.tree import tree_flatten, tree_unflatten

collectives.CHUNK_BYTES = 1 << 16
STEPS = 3
cases = pickle.load(open(f"{out}/cases.pkl", "rb"))


def whole_arena_step(ops, cfg, optimizer, layout, comm, ctx):
    """The mesh step before the slice plan: the arena all-gathered, the
    whole leaves' gradient packed and reduce-scattered; microbatched, in
    the reference's order (each microbatch's gradient reduce-scattered,
    divided by the shards and added into the span's accumulator, which
    is divided by the microbatches)."""
    tp_ctx, shards = _mesh_terms(cfg, comm, ctx)

    def step(state, batch):
        full = comm.all_gather(state.arena)
        params = unpack_arena(full, layout, copy=False)
        mb = max(cfg.microbatch, 1)
        if mb == 1:
            loss, g = loss_and_grad(ops, cfg, params, batch, tp_ctx)
            grads = comm.reduce_scatter(pack_values(g, layout))
            if shards > 1:
                grads.div_(shards)
        else:
            grads = torch.zeros((layout.shard_words,))
            loss = 0.0
            for bx in _microbatches(batch, mb):
                l, g, _ = _grad_leaves(ops, cfg, params, bx, tp_ctx)
                part = comm.reduce_scatter(pack_values(g, layout))
                if shards > 1:
                    part.div_(shards)
                grads.add_(part)
                loss = loss + l
            loss = loss / mb
            grads.div_(mb)
        loss = _mean_loss(loss, comm, tp_ctx, shards)
        arena, opt = arena_apply(optimizer, grads, state.opt_state,
                                 state.arena, layout,
                                 runs=layout.span_runs(comm.pos))
        return ArenaTrainState(arena, opt, state.step + 1,
                               state.layout), loss
    return step


def f32_bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


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
        n_data = world // model
        ds = ShardedLMDataset(cfg, 2 * n_data, 16, seed=3, device="cpu",
                              ctx=ctx)
        batches = [ds.next_batch() for _ in range(STEPS)]
        opt = adamw(3e-3)
        got = {}
        for route in ("slice", "whole"):
            state = ArenaTrainState.create(arena[w0:w1].clone(), opt, layout)
            make = make_arena_train_step if route == "slice" \
                else whole_arena_step
            step = make(ops, cfg, opt, layout, comm, ctx)
            collectives.reset_stats()
            losses = []
            for b in batches:
                state, loss = step(state, b)
                losses.append(float(loss))
            got[route] = (losses, state.arena.view(torch.float32),
                          state.opt_state.mu, state.opt_state.nu)
            if route == "slice":
                st = collectives.seconds_and_bytes()
                splan = step.plan
        tree = TrainState.create(params, opt)
        tstep = make_train_step(ops, cfg, opt, layout, comm, ctx)
        tlosses = []
        for b in batches:
            tree, loss = tstep(tree, b)
            tlosses.append(float(loss))
        tspan = pack_arena(tree.params, layout)[w0:w1].view(torch.float32)
        plan = SlicePlan(layout, mesh, _mesh_terms(cfg, comm, ctx)[0])
        s, w = got["slice"], got["whole"]
        res[f"{name}/{model}/{mb}"] = {
            "losses": [s[0], w[0], tlosses],
            "span_equal": bool(torch.equal(s[1], w[1])),
            "mu_equal": bool(torch.equal(s[2], w[2])),
            "nu_equal": bool(torch.equal(s[3], w[3])),
            "pytree_equal": bool(torch.equal(tspan, s[1])),
            "signed_zeros": int(sum((f32_bits(a) != f32_bits(b)).sum()
                                    for a, b in zip(s[1:], w[1:]))),
            "finite": bool(torch.isfinite(s[1]).all()),
            "values": plan.group_values(0),
            "outer_values": splan.group_values(0),
            "layer_values": sum(splan.group_values(g)
                                for g in range(1, splan.n_groups)),
            "layers": splan.n_groups - 1,
            "total_words": layout.total_words,
            "gather": st.get("slice_gather"),
            "reduce": st.get("slice_reduce"),
            "stats": sorted(st)}
json.dump(res, open(f"{out}/rank_{rank}.json", "w"))
dist.destroy_process_group()
'''


def _job(tmp_path: Path, world: int, cases: list) -> list:
    """Run the rank script's cases on ``world`` gloo ranks; their reports, in
    rank order. Fails when a rank fails or the ranks outlive
    ``DEADLINE``."""
    (tmp_path / "rank.py").write_text(RANK_SCRIPT)
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
            ("qwen3-moe-235b-a22b", 4)],
        2: [("mamba2-370m", 2)]}


@pytest.fixture(scope="module")
def gloo_jobs(tmp_path_factory):
    return {world: _job(tmp_path_factory.mktemp(f"slice_step_{world}"),
                        world, cases) for world, cases in JOBS.items()}


GLOO_CASES = [(w, n, m, mb) for w, cases in JOBS.items() for n, m in cases
              for mb in (1, 2)]


@pytest.mark.parametrize("world,name,model,mb", GLOO_CASES,
                         ids=[f"{n}-{w // m}x{m}-mb{mb}"
                              for w, n, m, mb in GLOO_CASES])
def test_slice_step_is_the_whole_arena_step_bit_for_bit(gloo_jobs, world,
                                                        name, model, mb):
    ranks = gloo_jobs[world]
    # words whose sign bit alone differs (a zero sum's): reported (``-s``),
    # since the values compare equal
    print(f"{name} {world // model}x{model} mb{mb}: signed zeros "
          f"{[r[f'{name}/{model}/{mb}']['signed_zeros'] for r in ranks]}")
    for r in ranks:
        got = r[f"{name}/{model}/{mb}"]
        s, w, t = got["losses"]
        assert s == w == t, r["rank"]
        assert s == ranks[0][f"{name}/{model}/{mb}"]["losses"][0]
        assert all(np.isfinite(s)) and got["finite"]
        assert got["span_equal"] and got["mu_equal"] and got["nu_equal"]
        assert got["pytree_equal"]
        # 3 steps of the rank's slices only: the outer group gathered once
        # a step, each layer in every microbatch's forward and recompute;
        # a reduce a group and microbatch
        n = got["layers"]
        assert got["gather"]["calls"] == 3 * (1 + 2 * mb * n)
        assert got["reduce"]["calls"] == 3 * mb * (1 + n)
        assert got["gather"]["result_bytes"] == 3 * 4 * (
            got["outer_values"] + 2 * mb * got["layer_values"])
        assert got["outer_values"] + got["layer_values"] == got["values"]
        assert got["values"] < got["total_words"]
        assert "all_gather" not in got["stats"]
        assert "reduce_scatter" not in got["stats"]
