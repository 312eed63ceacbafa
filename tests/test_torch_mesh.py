"""The sharded arena and the mesh's host-side functions, in process,
against the reference (``repro.core.arena``, ``repro.sharding.partition``,
``repro.launch.mesh``) exactly.

- the sharded layout (shards 1, 2, 4, 8): the reference's invariants, and
  every table equal to the reference's;
- ``relayout_arena`` / ``relayout_values``: shards 1 -> 4 -> 1 bit for
  bit, equal to the reference's words; ``span_overlaps``, their moves and
  the mesh's ``respan``'s, composing to them;
- ``arena_block_homes`` equal to the reference's;
- ``param_partition_specs``, ``state_partition_specs`` and
  ``batch_partition_specs`` on every reduced config, against the
  reference's on the same mesh shapes (the reference reads only a mesh's
  axis names and sizes, so it gets a stand-in mesh: this process has one
  device);
- ``blocks_on_failed_devices`` on the reference's draws;
- ``survivor_mesh``'s and ``make_host_mesh``'s shapes without a process
  group, the meshed fabric's configuration errors;
- the span sweeps of 1, 2 and 4 positions composed (the partial parity
  sent to each row's owner and folded there by ``parity_xor``, the
  scores summed) against one sweep of the whole arena: parity and
  replica bit for bit, scores within rtol 1e-6;
- the recovery of each span (positions as threads): the span restores,
  the span norms and the span parity reconstruction against the whole
  arena's, bit for bit (the norms within rtol 1e-5).

The runs over several ranks are in ``test_torch_mesh_spmd.py``.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import list_configs
from repro.core import arena as ja
from repro.core.blocks import partition_pytree as j_partition
from repro.launch.mesh import mesh_devices as j_mesh_devices
from repro.models import get_model as j_get_model
from repro.sharding import partition as jp
from repro_torch.configs import get_config
from repro_torch.core import arena as ta
from repro_torch.core.blocks import partition_pytree as t_partition
from repro_torch.core.policy import CheckpointPolicy
from repro_torch.fabric import CheckpointFabric, FabricConfig
from repro_torch.interop import from_numpy_tree
from repro_torch.kernels.fused_maintain.ops import (ArenaMaintainProgram,
                                                    SpanMaintainProgram,
                                                    arena_sweep,
                                                    restrict_plan,
                                                    sweep_plan)
from repro_torch.kernels.parity_xor.ops import parity_xor
from repro_torch.launch.mesh import (Mesh, make_host_mesh, mesh_devices,
                                     survivor_mesh)
from repro_torch.models import get_model
from repro_torch.sharding import partition as tp
from repro_torch.utils.tree import flatten_with_path, keystr

RNG = np.random.default_rng(11)
NP_PARAMS = {"w": RNG.normal(size=(96, 40)).astype(np.float32),
             "emb": RNG.normal(size=(65, 24)).astype(np.float32),
             "b": RNG.normal(size=(33,)).astype(np.float32),
             "s": np.float32(1.5)}


def _layouts(shards, params=NP_PARAMS, block_rows=8):
    jt = jax.tree_util.tree_map(jnp.asarray, params)
    tt = from_numpy_tree(params, "cpu")
    return (ja.build_arena_layout(j_partition(jt, block_rows), shards=shards),
            ta.build_arena_layout(t_partition(tt, block_rows), shards=shards),
            jt, tt)


# ---------------------------------------------------------------------------
# the sharded layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shards", [1, 2, 4, 8])
def test_sharded_layout_matches_reference(shards):
    """The shard pad only appends zero tiles: the data region is the
    ``shards=1`` layout's, every shard owns whole tiles, the pad is the
    least that makes the tiles divide; every table and gauge equals the
    reference's, the pad tiles' gid 0 included."""
    jl, tl, _, _ = _layouts(shards)
    base = ta.build_arena_layout(tl.partition)
    assert tl.shards == shards
    assert tl.data_words == base.data_words == base.total_words
    assert tl.n_tiles % shards == 0
    assert tl.shard_words * shards == tl.total_words
    assert tl.shard_words % ta.ARENA_TILE == 0
    assert tl.total_words - base.data_words < shards * ta.ARENA_TILE
    for f in ("shards", "data_words", "total_words", "n_tiles", "pad_words",
              "shard_words", "tail_start", "has_tail", "total_values",
              "padding_ratio", "leaf_offset", "seg_words"):
        assert getattr(tl, f) == getattr(jl, f), f
    np.testing.assert_array_equal(tl.tile_gids(), jl.tile_gids())
    n_pad = tl.pad_words // ta.ARENA_TILE
    if n_pad:
        assert (tl.tile_gids()[-n_pad:] == 0).all()
    assert [tl.span(p) for p in range(shards)] == [
        (p * tl.shard_words, (p + 1) * tl.shard_words)
        for p in range(shards)]


def test_sharded_layout_refuses_zero_shards():
    _, tl, _, _ = _layouts(1)
    with pytest.raises(ValueError):
        ta.build_arena_layout(tl.partition, shards=0)
    with pytest.raises(ValueError):
        tl.span(1)


def test_relayout_round_trip_bit_exact():
    """shards 1 -> 4 -> 1 round-trips bit for bit with a zero pad, each
    arena decodes to the tree, and the words equal the reference's; the
    value-domain moments move the same way; layouts of another partition
    refuse."""
    jl1, tl1, jt, tt = _layouts(1)
    jl4, tl4, _, _ = _layouts(4)
    a1 = ta.pack_arena(tt, tl1)
    a4 = ta.relayout_arena(a1, tl1, tl4)
    want = np.asarray(ja.relayout_arena(ja.pack_arena(jt, jl1), jl1, jl4))
    np.testing.assert_array_equal(a4.numpy(), want.view(np.int32))
    assert not a4[tl4.data_words:].any()
    for lay, arena in ((tl1, a1), (tl4, a4)):
        for x, y in zip(jax.tree_util.tree_leaves(jt),
                        jax.tree_util.tree_leaves(ta.unpack_arena(arena,
                                                                  lay))):
            np.testing.assert_array_equal(np.asarray(x), y.numpy())
    assert torch.equal(ta.relayout_arena(a4, tl4, tl1), a1)
    vals = torch.from_numpy(RNG.normal(size=tl1.total_values)
                            .astype(np.float32))
    v4 = ta.relayout_values(vals, tl1, tl4)
    np.testing.assert_array_equal(
        v4.numpy(), np.asarray(ja.relayout_values(vals.numpy(), jl1, jl4)))
    assert torch.equal(ta.relayout_values(v4, tl4, tl1), vals)
    _, other, _, _ = _layouts(4, {"w": np.zeros((16, 8), np.float32)})
    with pytest.raises(ValueError):
        ta.relayout_arena(a1, tl1, other)
    with pytest.raises(ValueError):
        ta.relayout_values(vals, tl1, other)


@pytest.mark.parametrize("old,new", [(1, 4), (4, 2), (2, 8), (8, 4)])
def test_span_overlaps_move_the_sharded_arena(old, new):
    """The moves ``respan`` makes across a shard-count change, applied to
    the old layout's spans, give the new layout's spans of
    ``relayout_arena`` bit for bit: every data word moved once, the shard
    pad zero."""
    _, lo_, _, tt = _layouts(old)
    _, ln_, _, _ = _layouts(new)
    a = ta.pack_arena(tt, lo_)
    spans = [torch.zeros(ln_.shard_words, dtype=torch.int32)
             for _ in range(new)]
    moved = 0
    for p, q, lo, hi in ta.span_overlaps(old, lo_.shard_words, new,
                                         ln_.shard_words, ln_.data_words):
        src = a[p * lo_.shard_words:(p + 1) * lo_.shard_words]
        spans[q][lo - q * ln_.shard_words:hi - q * ln_.shard_words] = \
            src[lo - p * lo_.shard_words:hi - p * lo_.shard_words]
        moved += hi - lo
    assert moved == ln_.data_words
    assert torch.equal(torch.cat(spans), ta.relayout_arena(a, lo_, ln_))


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_arena_block_homes_match_reference(shards):
    """Each gid's home is the shard holding the first tile of its first
    arena block, the reference's; a device count that does not divide the
    tiles raises."""
    jl, tl, _, _ = _layouts(shards)
    homes = ta.arena_block_homes(tl)
    np.testing.assert_array_equal(homes, ja.arena_block_homes(jl))
    assert homes.min() >= 0 and homes.max() < shards
    for ab in tl.blocks:
        assert homes[ab.gid] == ab.offset // tl.shard_words
    if shards == 2:
        with pytest.raises(ValueError):
            ta.arena_block_homes(tl, n_devices=5)


# ---------------------------------------------------------------------------
# partition specs
# ---------------------------------------------------------------------------

MESH_SHAPES = [(4, 2), (2, 16)]


def _ctxs(shape):
    """The port's context on a mesh of ``shape`` and the reference's on a
    stand-in mesh with the same axis names and sizes."""
    axes = ("data", "model")
    t_mesh = Mesh(np.arange(int(np.prod(shape))).reshape(shape), axes)
    j_mesh = types.SimpleNamespace(axis_names=axes,
                                   shape=dict(zip(axes, shape)))
    return tp.make_dist_ctx(t_mesh), jp.make_dist_ctx(j_mesh)


def _named(tree) -> list:
    flat, _ = flatten_with_path(tree)
    return [(keystr(p), tuple(s)) for p, s in flat]


def _j_named(tree) -> list:
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
    return [(jax.tree_util.keystr(p), tuple(s)) for p, s in flat]


@pytest.mark.parametrize("shape", MESH_SHAPES)
@pytest.mark.parametrize("name", list_configs())
def test_param_specs_match_reference(name, shape):
    """The port's parameter tree of every reduced config gets the
    reference's FSDP+TP specs, leaf by leaf; a context without a mesh
    replicates everything."""
    tctx, jctx = _ctxs(shape)
    jcfg = j_get_config(name, reduced=True)
    j_shape = jax.eval_shape(
        lambda: j_get_model(jcfg).init_params(jax.random.PRNGKey(0), jcfg))
    cfg = get_config(name, reduced=True)
    params = get_model(cfg).init_params(torch.Generator().manual_seed(0),
                                        cfg, device="cpu")
    got = _named(tp.param_partition_specs(params, tctx))
    assert got == _j_named(jp.param_partition_specs(j_shape, jctx))
    assert any(s for _, s in got)
    none = tp.param_partition_specs(params, tp.single_device_ctx())
    assert all(s == () for _, s in _named(none))
    assert all(isinstance(s, tp.PartitionSpec)
               for _, s in flatten_with_path(none)[0])


@pytest.mark.parametrize("shape", MESH_SHAPES)
@pytest.mark.parametrize("name", list_configs())
def test_state_and_batch_specs_match_reference(name, shape):
    """The serving caches' and an input batch's specs: the reference's."""
    tctx, jctx = _ctxs(shape)
    jcfg = j_get_config(name, reduced=True)
    jops = j_get_model(jcfg)
    if jops.init_cache is None:
        pytest.skip(f"{name} has no serving cache")
    j_cache = jax.eval_shape(
        lambda: jops.init_cache(jcfg, 8, 64, jp.single_device_ctx()))
    cfg = get_config(name, reduced=True)
    cache = get_model(cfg).init_cache(cfg, 8, 64, device="cpu")
    assert _named(tp.state_partition_specs(cache, tctx)) \
        == _j_named(jp.state_partition_specs(j_cache, jctx))
    batch = {"tokens": np.zeros((8, 16), np.int32),
             "patches": np.zeros((8, 4, 12), np.float32)}
    assert _named(tp.batch_partition_specs(batch, tctx)) \
        == _j_named(jp.batch_partition_specs(batch, jctx))


@pytest.mark.parametrize("fraction", [0.25, 0.5])
def test_blocks_on_failed_devices_match_reference(fraction):
    """A failed slice of the data axis loses the blocks homed there: the
    reference's mask from the same draws."""
    tctx, jctx = _ctxs((4, 2))
    _, _, jt, tt = _layouts(1)
    got = tp.blocks_on_failed_devices(
        t_partition(tt, 8), None, tctx, fraction,
        np.random.default_rng(5))
    want = jp.blocks_on_failed_devices(
        j_partition(jt, 8), None, jctx, fraction, np.random.default_rng(5))
    np.testing.assert_array_equal(got, np.asarray(want))
    assert got.any() and not got.all()


# ---------------------------------------------------------------------------
# meshes and the meshed fabric's configuration
# ---------------------------------------------------------------------------

def test_survivor_and_host_meshes_without_a_process_group():
    """Without a process group a mesh is rank 0 alone: the survivor mesh
    of ``[0]`` is ``(1, 1)`` over ``("data", "model")``, as the
    reference's of one device, and the host mesh is the same shape."""
    m = survivor_mesh([0])
    assert m.devices.shape == (1, 1)
    assert m.axis_names == ("data", "model")
    assert mesh_devices(m) == [0] and m.position() == 0
    assert m.shape == {"data": 1, "model": 1}
    host = make_host_mesh()
    assert host.devices.shape == (1, 1) and host.group is None
    jm = types.SimpleNamespace(devices=np.asarray([["d0"]], dtype=object))
    assert j_mesh_devices(jm) == ["d0"]
    with pytest.raises(ValueError):
        survivor_mesh([0, 1])
    with pytest.raises(ValueError):
        make_host_mesh(model=2)


def test_meshed_fabric_configuration_errors():
    """A mesh whose size is not ``n_devices`` is a misconfiguration, not a
    fallback; so are a non-mesh object, the per-leaf, RS and async
    pipelines and a mixed-dtype model on a mesh; a controller on a mesh
    needs the arena checkpoint."""
    from repro_torch.core.controller import FTController
    part = t_partition(from_numpy_tree(NP_PARAMS, "cpu"), 8)
    m = survivor_mesh([0])
    with pytest.raises(ValueError, match="mesh"):
        CheckpointFabric(part, FabricConfig(n_devices=8), mesh=m)
    with pytest.raises(TypeError, match="Mesh"):
        CheckpointFabric(part, FabricConfig(n_devices=1), mesh=object())
    for cfg in (FabricConfig(n_devices=1, fused=False),
                FabricConfig(n_devices=1, arena=False),
                FabricConfig(n_devices=1, rs_parity=1),
                FabricConfig(n_devices=1, async_maintain=True)):
        with pytest.raises(ValueError, match="arena"):
            CheckpointFabric(part, cfg, mesh=m)
    mixed = from_numpy_tree({"w": NP_PARAMS["w"]}, "cpu")
    mixed["h"] = torch.zeros((16, 8), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="all-f32"):
        CheckpointFabric(t_partition(mixed, 8), FabricConfig(n_devices=1),
                         mesh=m)
    fab = CheckpointFabric(part, FabricConfig(n_devices=1), mesh=m)
    assert fab.arena_layout.shards == 1 and fab.comm is not None
    params = from_numpy_tree(NP_PARAMS, "cpu")
    with pytest.raises(ValueError, match="arena checkpoint"):
        FTController(params, CheckpointPolicy.scar(), device="cpu",
                     fabric=FabricConfig(n_devices=1), mesh=m,
                     inplace_save=False)


# ---------------------------------------------------------------------------
# the span sweeps against one sweep of the whole arena
# ---------------------------------------------------------------------------

def _sweep_case():
    params = {"w": RNG.normal(size=(200, 40)).astype(np.float32),
              "emb": RNG.normal(size=(130, 24)).astype(np.float32),
              "b": RNG.normal(size=(33,)).astype(np.float32),
              "c": RNG.normal(size=(17, 3)).astype(np.float32),
              "s": np.float32(1.5)}
    return from_numpy_tree(params, "cpu")


@pytest.mark.parametrize("n", [1, 2, 4])
def test_span_sweeps_compose_to_the_whole_sweep(n):
    """Each of ``n`` positions sweeps its span (restricted plan, compact
    partial parity); the partial tiles sent to each row's owner and folded
    there by parity_xor give the whole sweep's parity bit for bit, the
    span replicas its replica, and the summed per-block scores its scores
    (within rtol 1e-6: blocks that straddle a span edge sum two parts).
    Over the whole arena the restricted plan is the plan."""
    tree = _sweep_case()
    part = t_partition(tree, 8)
    fab = CheckpointFabric(part, FabricConfig(n_devices=4,
                                              devices_per_host=2))
    codec = fab.parity
    lay = ta.build_arena_layout(part, shards=n)
    live = ta.pack_arena(tree, lay)
    ckpt = live.clone().view(torch.float32).add_(
        torch.from_numpy(RNG.normal(size=lay.total_words).astype(
            np.float32)) * 1e-2).view(torch.int32)
    ckpt[lay.data_words:] = 0
    whole = ArenaMaintainProgram(part, lay, codec.layout, codec.group_of,
                                 codec.n_groups)
    w_rep, w_scores, w_par = whole(live, ckpt)
    full = sweep_plan(lay, codec.layout, codec.group_of)
    same, dests = restrict_plan(full, lay, 0, lay.n_tiles)
    np.testing.assert_array_equal(dests, full.dest_tile)
    for f in ("mem_ptr", "mem_tile", "tail_ptr", "tail_pos", "tail_word",
              "tb_off", "tb_len", "ab_seg0", "ab_nseg"):
        np.testing.assert_array_equal(getattr(same, f), getattr(full, f))
    progs = [SpanMaintainProgram(part, lay, codec.layout, codec.group_of,
                                 codec.n_groups, p, n) for p in range(n)]
    partials, reps, scores = [], [], torch.zeros_like(w_scores)
    for p, prog in enumerate(progs):
        w0, w1 = lay.span(p)
        partial, _ = prog.buffers(live.device)
        rep = torch.empty_like(live[w0:w1])
        scores += arena_sweep(live[w0:w1].clone(), ckpt[w0:w1].clone(),
                              prog.plan, parity=partial, replica=rep)
        tail = max(lay.tail_start - w0, 0)
        rep[tail:] = live[w0:w1][tail:]
        reps.append(rep)
        partials.append(partial[:prog.dest_full.size * ta.ARENA_TILE])
    rows = []
    for r, prog in enumerate(progs):
        recv = []
        for k in range(n):
            off = np.concatenate([[0], np.cumsum(progs[k].send_counts)])
            recv.append(partials[k][off[r]:off[r + 1]])
        _, owned = prog.buffers(live.device)
        parity_xor(owned, torch.cat(recv), None, prog.combine)
        g0, g1 = prog.row_range()
        rows.append(owned.view(prog.rows_per, -1)[:g1 - g0])
    assert torch.equal(torch.cat(rows), w_par)
    assert torch.equal(torch.cat(reps), w_rep)
    np.testing.assert_allclose(scores.numpy(), w_scores.numpy(), rtol=1e-6,
                               atol=1e-30)


# ---------------------------------------------------------------------------
# the recovery of each span against the recovery of the whole arena
# ---------------------------------------------------------------------------

class _ThreadComm:
    """Position ``pos`` of an ``n``-position mesh run as threads of this
    process: the collectives :mod:`repro_torch.fabric.span_recovery`
    calls, exchanged through a shared box."""

    def __init__(self, pos, n, box, barrier):
        self.pos, self.n, self.box, self.barrier = pos, n, box, barrier

    def _swap(self, item):
        self.box[self.pos] = item
        self.barrier.wait()
        got = list(self.box)
        self.barrier.wait()
        return got

    def all_gather(self, t):
        return torch.cat([x.reshape(-1) for x in self._swap(t)])

    def all_to_all(self, send, send_counts, recv_counts, max_count):
        off = np.concatenate([[0], np.cumsum(send_counts)])
        got = self._swap([send[off[k]:off[k + 1]] for k in range(self.n)])
        out = torch.cat([got[k][self.pos] for k in range(self.n)])
        assert out.numel() == sum(recv_counts)
        return out


def _on_positions(n, fn):
    """``fn(position, comm)`` on ``n`` threads; their results in position
    order."""
    import threading
    box, barrier = [None] * n, threading.Barrier(n, timeout=60)
    out, errors = [None] * n, []

    def body(p):
        try:
            out[p] = fn(p, _ThreadComm(p, n, box, barrier))
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors.append(e)
            barrier.abort()
    threads = [threading.Thread(target=body, args=(p,)) for p in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    if errors:
        raise errors[0]
    return out


def _span_case(n):
    tree = _sweep_case()
    part = t_partition(tree, 8)
    lay = ta.build_arena_layout(part, shards=n)
    live = ta.pack_arena(tree, lay)
    # another tree's pack: its pad words are zero, as in every arena
    other = ta.pack_arena({k: v + 1e-2 * torch.from_numpy(
        RNG.normal(size=v.shape).astype(np.float32)) for k, v in tree.items()},
        lay)
    return tree, part, lay, live, other


@pytest.mark.parametrize("n", [1, 2, 4])
def test_span_restores_compose_to_the_whole_restore(n):
    """masked_restore of each span (main tiles a row each, tail words a
    row each) gives the whole arena's restore, tail blocks and blocks that
    straddle a span edge included, bit for bit."""
    from repro_torch.fabric.span_recovery import span_restore, span_tables
    tree, part, lay, live, other = _span_case(n)
    assert lay.has_tail
    mask = RNG.random(part.total_blocks) < 0.4
    want = ta.pack_arena(ta.arena_restore_ref(tree, other, mask, lay), lay)
    got = live.clone()
    for p in range(n):
        w0, w1 = lay.span(p)
        span_restore(got[w0:w1], other[w0:w1], mask, span_tables(lay, p))
    assert torch.equal(got, want)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_mesh_block_sq_is_the_tree_scores(n):
    """The spans' block_dist parts, all-gathered and summed in position
    order, are the whole tree's per-block squared distances (rtol 1e-5:
    float64 sums of per-tile parts), the same bits on every position."""
    from repro_torch.fabric.span_recovery import mesh_block_sq, span_tables
    from repro_torch.kernels.block_dist.ops import tree_block_scores
    tree, part, lay, live, other = _span_case(n)

    def fn(p, comm):
        w0, w1 = lay.span(p)
        return mesh_block_sq(live[w0:w1], other[w0:w1], span_tables(lay, p),
                             part.total_blocks, comm)
    got = _on_positions(n, fn)
    want = tree_block_scores(tree, ta.unpack_arena(other, lay), part)
    for g in got:
        np.testing.assert_array_equal(g, got[0])
    np.testing.assert_allclose(got[0], want.double().numpy(), rtol=1e-5)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_span_reconstructs_compose_to_the_whole_reconstruct(n):
    """One erasure in every other parity group, the lost words garbled in
    the live arena and in the snapshot: each position folds its span's
    terms with the rows it owns, the partial words go to the spans they
    restore and are folded there (parity_xor), and the arena is the live
    one again, bit for bit."""
    from repro_torch.fabric.span_recovery import (span_reconstruct,
                                                  span_restore, span_tables)
    from repro_torch.kernels.parity_xor.ops import reconstruct_plan
    tree, part, lay, live, noise = _span_case(n)
    fab = CheckpointFabric(part, FabricConfig(n_devices=4,
                                              devices_per_host=2))
    codec = fab.parity
    par = codec.encode_arena(live[:lay.data_words])
    lost = np.zeros(part.total_blocks, bool)
    for j in range(0, codec.n_groups, 2):
        lost[codec.members[j][0]] = True
    plan, blocks = reconstruct_plan(lay, codec.layout, codec.group_of,
                                    codec.members, np.nonzero(lost)[0],
                                    codec.member_mask(~lost))
    garbled = live.clone()
    for p in range(n):
        w0, w1 = lay.span(p)
        span_restore(garbled[w0:w1], noise[w0:w1], lost, span_tables(lay, p))
    assert not torch.equal(garbled, live)
    rows_per = -(-codec.n_groups // n)
    fe = codec.layout.frame_elems
    snap = garbled.clone()

    def fn(p, comm):
        w0, w1 = lay.span(p)
        owned = torch.zeros((rows_per, fe), dtype=torch.int32)
        g0, g1 = min(p * rows_per, codec.n_groups), min((p + 1) * rows_per,
                                                          codec.n_groups)
        owned[:g1 - g0] = par[g0:g1]
        span_reconstruct(garbled[w0:w1], snap[w0:w1], owned, plan, blocks,
                         lay, p * rows_per, (p + 1) * rows_per, fe, comm)
    _on_positions(n, fn)
    assert torch.equal(garbled, live)


# ---------------------------------------------------------------------------
# the context and the trainer on a one-position mesh, in process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shardable", [True, False])
@pytest.mark.parametrize("axes,shape", [(("data", "model"), (4, 2)),
                                        (("pod", "data", "model"), (2, 2, 4))])
def test_dist_context_matches_reference(axes, shape, shardable):
    """``make_dist_ctx``'s batch and model axes, ``dp_spec``,
    ``raw_dp_spec`` and ``tp_size`` are the reference's."""
    t_mesh = Mesh(np.arange(int(np.prod(shape))).reshape(shape), axes)
    j_mesh = types.SimpleNamespace(axis_names=axes,
                                   shape=dict(zip(axes, shape)))
    t, j = (tp.make_dist_ctx(t_mesh, shardable),
            jp.make_dist_ctx(j_mesh, shardable))
    for f in ("dp", "tp", "dp_spec", "raw_dp_spec", "tp_size",
              "batch_shardable"):
        assert getattr(t, f) == getattr(j, f), f
    one = tp.single_device_ctx()
    assert (one.dp, one.tp, one.tp_size, one.dp_spec) == ((), None, 1, None)


def _mesh_loop(fabric, recorder=None, ctx=None, **policy):
    from repro_torch.training import TrainLoop, TrainLoopConfig
    cfg = dataclasses.replace(get_config("qwen2-1.5b", reduced=True),
                              n_layers=1)
    return cfg, TrainLoop(cfg, loop_cfg=TrainLoopConfig(
        policy=CheckpointPolicy.scar(fraction=0.25, interval=2, **policy),
        fabric=fabric, per_layer_leaves=False, recorder=recorder),
        device="cpu", ctx=ctx)


def test_one_position_mesh_in_process():
    """Without a process group a one-position mesh trains as the loop
    without one, bit for bit: losses, the checkpoint arena, the arena."""
    from repro_torch.data import ShardedLMDataset
    ctx = tp.make_dist_ctx(make_host_mesh())
    runs = []
    for c in (ctx, None):
        cfg, loop = _mesh_loop(FabricConfig(n_devices=1,
                                            devices_per_host=1), ctx=c)
        state = loop.init_state(torch.Generator().manual_seed(3))
        state = loop.run(state, iter(ShardedLMDataset(
            cfg, 2, 16, device="cpu", ctx=c)), 3)
        runs.append(([m["loss"] for m in loop.metrics],
                     loop.controller._ckpt_arena, state.arena))
    (la, ca, aa), (lb, cb, ab) = runs
    assert la == lb and torch.equal(ca, cb) and torch.equal(aa, ab)


def test_arena_gated_event_on_a_mesh():
    """A policy the arena checkpoint cannot serve (PRIORITY under the
    linf norm) on a mesh: the trainer records ``fabric/arena_gated`` with
    the reason and raises; there is no tree-path fallback on a mesh."""
    from repro_torch.telemetry import Recorder
    rec = Recorder()
    _, loop = _mesh_loop(FabricConfig(n_devices=1), recorder=rec,
                         ctx=tp.make_dist_ctx(make_host_mesh()),
                         norm="linf")
    with pytest.raises(ValueError, match="arena checkpoint"):
        loop.init_state()
    assert [e["kind"] for e in rec.events] == ["fabric/arena_gated"]


def test_arena_sharding_and_shard_arena_state():
    """Position ``i`` of a mesh owns the span ``[i * total / n, (i + 1) *
    total / n)``; ``shard_arena_state`` keeps this rank's span of the
    arena and of each moment and the step count (no process group: rank
    0, position 0)."""
    from repro_torch.optim import adamw
    from repro_torch.training import ArenaTrainState
    _, lay, _, tt = _layouts(4)
    mesh = Mesh(np.arange(4).reshape(2, 2), ("data", "model"))
    assert tp.arena_sharding(mesh, lay) == [lay.span(i) for i in range(4)]
    with pytest.raises(ValueError):
        tp.arena_sharding(survivor_mesh([0]), lay)
    state = ArenaTrainState.create(ta.pack_arena(tt, lay), adamw(1e-3), lay)
    state.opt_state.mu.add_(1.0)
    cut = tp.shard_arena_state(state, mesh)
    w0, w1 = lay.span(0)
    assert torch.equal(cut.arena, state.arena[w0:w1])
    assert torch.equal(cut.opt_state.mu, state.opt_state.mu[w0:w1])
    assert torch.equal(cut.opt_state.nu, state.opt_state.nu[w0:w1])
    assert cut.step == state.step and cut.layout is lay
