"""The fabric's kernels and their drivers, port against reference.

Each check feeds both packages the same numpy trees and the same
placement. On the CPU the port runs each kernel's plain version; the
reference runs its Pallas kernel in interpret mode where it has one for
the layout (uniform f32 without a tail region) and its jnp path
elsewhere, as its own tests do.

- ``arena_routing``, ``leaf_group_metas``, the parity striping and homes,
  and ``maintain_traffic`` are equal;
- the arena sweep's parity is bit-equal to ``ArenaMaintainProgram``'s and
  its scores within rtol 1e-5, on f32, tail, quantized and colocated
  layouts, through the pack, owned and resident paths;
- ``arena_scatter_save`` is bit-equal and moves the same bytes;
- parity encode equals ``parity_xor_ref`` over the reference's gathered
  frames, and reconstruction equals ``_reconstruct_frames`` bit for bit,
  then decodes into the same values.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import arena as ja
from repro.core.blocks import partition_pytree as j_partition
from repro.fabric.domains import FailureDomainMap as JDomains
from repro.fabric.parity import ParityCodec as JCodec
from repro.fabric.parity import pack_frames as j_pack_frames
from repro.fabric.parity import unpack_frames_into as j_unpack_frames
from repro.fabric.placement import ClusterView as JView
from repro.kernels.fused_maintain import ops as jops
from repro.kernels.parity_xor.ref import parity_xor_ref as j_parity_xor_ref
from repro.sharding.partition import block_device_homes as j_homes
from repro_torch.core import arena as ta
from repro_torch.core.blocks import partition_pytree as t_partition
from repro_torch.fabric.domains import FailureDomainMap as TDomains
from repro_torch.fabric.parity import ParityCodec as TCodec
from repro_torch.fabric.parity import pack_frames as t_pack_frames
from repro_torch.fabric.parity import unpack_frames_into as t_unpack_frames
from repro_torch.fabric.parity import unpack_segments_into
from repro_torch.fabric.placement import ClusterView as TView
from repro_torch.interop import from_numpy_tree, to_numpy_tree
from repro_torch.kernels.fused_maintain import ops as tops
from repro_torch.kernels.parity_xor.ops import encode_plan, parity_xor
from repro_torch.sharding.partition import block_device_homes as t_homes


def _leaf(rng, shape, dtype):
    if np.dtype(dtype).kind in "iu":
        return rng.integers(-100, 100, shape).astype(dtype)
    return rng.normal(size=shape).astype(np.float32).astype(dtype)


def _tree(kind, seed=0):
    """f32: uniform f32, no tail; tail: f32 with tail leaves; quant: bf16,
    fp8, int8 and f16 leaves with a tail; colocate: shared block ids."""
    rng = np.random.default_rng(seed)
    if kind == "f32":
        return {"big": _leaf(rng, (40, 300), np.float32),
                "w": _leaf(rng, (96, 12), np.float32),
                "v": _leaf(rng, (24, 80), np.float32)}
    if kind == "tail":
        return {"big": _leaf(rng, (40, 300), np.float32),
                "w": _leaf(rng, (50, 6), np.float32),
                "b": _leaf(rng, (5,), np.float32),
                "c": _leaf(rng, (3, 7), np.float32),
                "s": _leaf(rng, (), np.float32)}
    if kind == "quant":
        return {"big": _leaf(rng, (40, 300), ml_dtypes.bfloat16),
                "e": _leaf(rng, (64, 33), ml_dtypes.float8_e4m3fn),
                "i": _leaf(rng, (48, 20), np.int8),
                "h": _leaf(rng, (9,), np.float16),
                "b": _leaf(rng, (6,), ml_dtypes.bfloat16)}
    net = {"a": _leaf(rng, (40, 40), np.float32),
           "b": _leaf(rng, (7,), np.float32)}
    return {"net": net, "mu": {k: v * 0.5 for k, v in net.items()}}


def _to_jax(tree):
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    return jnp.asarray(tree)


def _bits(x):
    return np.asarray(x).view(np.int32)


class Both:
    """One tree's partition, arena layout and parity codec in each
    package, on the same logical topology (8 devices, 4 hosts)."""

    def __init__(self, kind, block_rows=8, group_size=3, seed=0):
        self.np_tree = _tree(kind, seed)
        col = ("net", "mu") if kind == "colocate" else ()
        self.jt = _to_jax(self.np_tree)
        self.tt = from_numpy_tree(self.np_tree, "cpu")
        self.jp = j_partition(self.jt, block_rows, colocate=col)
        self.tp = t_partition(self.tt, block_rows, colocate=col)
        self.jl = ja.build_arena_layout(self.jp)
        self.tl = ta.build_arena_layout(self.tp)
        self.jc = JCodec(self.jp, JView(JDomains(8, 2, 2),
                                        j_homes(self.jp, 8)),
                         group_size=group_size, use_pallas=False)
        self.tc = TCodec(self.tp, TView(TDomains(8, 2, 2),
                                        t_homes(self.tp, 8)),
                         group_size=group_size, arena_layout=self.tl)

    def drifted(self, seed):
        rng = np.random.default_rng(seed)
        out = jax.tree_util.tree_map(
            lambda x: _leaf(rng, x.shape, x.dtype), self.np_tree)
        return _to_jax(out), from_numpy_tree(out, "cpu")


KINDS = ["f32", "tail", "quant", "colocate"]


@pytest.mark.parametrize("kind", KINDS)
def test_striping_routing_and_traffic_equal(kind):
    b = Both(kind)
    for f in ("members", "group_of", "parity_homes"):
        np.testing.assert_array_equal(getattr(b.tc, f), getattr(b.jc, f))
    assert b.tc.layout == type(b.tc.layout)(*vars(b.jc.layout).values())
    jr = jops.arena_routing(b.jl, b.jc.layout, b.jc.group_of)
    tr = tops.arena_routing(b.tl, b.tc.layout, b.tc.group_of)
    for f in ("perm", "dest", "first", "touched", "members", "tile_gid"):
        np.testing.assert_array_equal(getattr(tr, f), getattr(jr, f), f)
    assert tr.frame_tiles == jr.frame_tiles
    for jm, tm in zip(jops.leaf_group_metas(b.jp, b.jc.layout, b.jc.group_of),
                      tops.leaf_group_metas(b.tp, b.tc.layout,
                                            b.tc.group_of)):
        for f in ("perm", "outrow", "first", "touched", "members"):
            np.testing.assert_array_equal(getattr(tm, f), getattr(jm, f))
    want = jops.maintain_traffic(b.jp, b.jc.layout, b.jc.group_of,
                                 b.jc.n_groups, b.jc.members.shape[1],
                                 arena_layout=b.jl)
    got = tops.maintain_traffic(b.tp, b.tc.layout, b.tc.group_of,
                                b.tc.n_groups, b.tc.members.shape[1],
                                arena_layout=b.tl)
    assert got == want


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("path", ["pack", "owned", "resident"])
def test_arena_sweep_matches_program(kind, path):
    b = Both(kind)
    use_pallas = kind == "f32"       # the Pallas kernel's own layouts
    jprog = jops.ArenaMaintainProgram(b.jp, b.jl, b.jc.layout, b.jc.group_of,
                                      b.jc.n_groups, use_pallas=use_pallas,
                                      interpret=True)
    tprog = tops.ArenaMaintainProgram(b.tp, b.tl, b.tc.layout, b.tc.group_of,
                                      b.tc.n_groups)
    jz, tz = b.drifted(7)
    jrep, jsc, jpar = jprog(b.jt, ja.pack_arena(jz, b.jl))
    live = ta.pack_arena(b.tt, b.tl)
    zarena = ta.pack_arena(tz, b.tl)
    params = {"pack": b.tt, "owned": live, "resident": live}[path]
    trep, tsc, tpar = tprog(params, zarena, own_live=path == "owned")
    np.testing.assert_array_equal(tpar.numpy(), np.asarray(jpar))
    np.testing.assert_array_equal(trep.numpy(), _bits(jrep))
    assert (trep is live) == (path == "owned")
    want = np.asarray(jsc)
    np.testing.assert_allclose(tsc.numpy(), want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))
    # a second sweep rewrites the same parity buffer, without scores
    rep2, sc2, par2 = tprog(b.tt)
    assert par2 is tpar and not sc2.any()
    np.testing.assert_array_equal(par2.numpy(), np.asarray(jpar))
    # the parity equals the reference codec's tree-path encode
    b.jc.encode(0, b.jt)
    np.testing.assert_array_equal(tpar.numpy(), np.asarray(b.jc.parity))


@pytest.mark.parametrize("kind", KINDS)
def test_arena_scatter_save_matches(kind):
    b = Both(kind)
    jz, tz = b.drifted(3)
    rng = np.random.default_rng(11)
    total = b.tp.total_blocks
    for k in (1, max(1, total // 3), total):
        ids = rng.choice(total, size=k, replace=False)
        jdst = ja.pack_arena(jz, b.jl)
        want, jmoved = jops.arena_scatter_save(jdst, ja.pack_arena(b.jt, b.jl),
                                               b.jl, ids, use_pallas=False)
        tdst = ta.pack_arena(tz, b.tl)
        got, tmoved = tops.arena_scatter_save(tdst, ta.pack_arena(b.tt, b.tl),
                                              b.tl, ids)
        assert got is tdst                      # in place
        np.testing.assert_array_equal(got.numpy(), _bits(want))
        assert tmoved == jmoved == b.tl.seg_bytes_for_blocks(ids)


@pytest.mark.parametrize("kind", KINDS)
def test_parity_encode_and_reconstruct_match(kind):
    b = Both(kind)
    frames = j_pack_frames(b.jt, b.jp, b.jc.layout)
    np.testing.assert_array_equal(
        t_pack_frames(b.tt, b.tp, b.tc.layout).numpy(), np.asarray(frames))
    # encode: the arena-term form against parity_xor_ref on gathered frames
    want_par = j_parity_xor_ref(frames[jnp.asarray(b.jc._gather_ids)],
                                jnp.zeros((b.jc.n_groups,
                                           b.jc.layout.frame_elems),
                                          jnp.int32),
                                jnp.asarray(b.jc.valid))
    arena = ta.pack_arena(b.tt, b.tl)
    fe = b.tc.layout.frame_elems
    got = parity_xor(torch.full((b.tc.n_groups * fe,), -1, dtype=torch.int32),
                     arena, None, encode_plan(b.tl, b.tc.layout,
                                              b.tc.members))
    np.testing.assert_array_equal(got.view(-1, fe).numpy(),
                                  np.asarray(want_par))
    b.jc.encode(0, b.jt)
    b.tc.encode(0, b.tt)
    np.testing.assert_array_equal(b.tc.parity.numpy(),
                                  np.asarray(b.jc.parity))
    # reconstruct one member of every other group (single erasures)
    total = b.tp.total_blocks
    lost = np.zeros((total,), bool)
    for j, row in enumerate(b.tc.members):
        if j % 2 == 0:
            lost[row[row >= 0][-1]] = True
    rec = b.jc.reconstructable(lost, ~lost, np.empty((0,), np.int32), 0)
    assert (b.tc.reconstructable(lost, ~lost, np.empty((0,), np.int32), 0)
            == rec).all() and rec.any()
    want = np.asarray(b.jc._reconstruct_frames(frames, rec, ~lost))
    blocks, words = b.tc.reconstruct_from_arena(arena, b.tl, rec, ~lost)
    ab = b.tl.ab_arrays()
    off = 0
    for a in blocks:
        col = b.tc.layout.cols[ab["leaf"][a]]
        n = ab["payload"][a]
        np.testing.assert_array_equal(
            words[off:off + n].numpy(), want[ab["gid"][a], col:col + n])
        off += n
    assert off == words.numel()
    # the tree path (pack first) gives the same words
    b2, w2 = b.tc.reconstruct(b.tt, rec, ~lost)
    np.testing.assert_array_equal(b2, blocks)
    assert torch.equal(w2, words)
    # decoding into a zeroed tree restores exactly the lost blocks
    zero_np = jax.tree_util.tree_map(np.zeros_like, b.np_tree)
    jrec = j_unpack_frames(_to_jax(zero_np), jnp.asarray(want), rec, b.jp,
                           b.jc.layout)
    trec = unpack_segments_into(from_numpy_tree(zero_np, "cpu"), blocks,
                                words, b.tl)
    tfr = t_unpack_frames(from_numpy_tree(zero_np, "cpu"),
                          torch.from_numpy(want.copy()), rec, b.tp, b.tc.layout)
    for x, y, z in zip(jax.tree_util.tree_leaves(to_numpy_tree(trec)),
                       jax.tree_util.tree_leaves(jrec),
                       jax.tree_util.tree_leaves(to_numpy_tree(tfr))):
        np.testing.assert_array_equal(np.asarray(x).reshape(-1).view(np.uint8),
                                      np.asarray(y).reshape(-1).view(np.uint8))
        np.testing.assert_array_equal(np.asarray(z).reshape(-1).view(np.uint8),
                                      np.asarray(y).reshape(-1).view(np.uint8))
