"""The flat word arena, port against reference (``core/arena.py``).

The same trees, drawn with numpy, go through both packages:

- packed arenas of f32, bf16, f16, fp8 (e4m3fn, e5m2), int8 and mixed
  trees are byte-equal to the reference's, and unpack bit-exactly;
- the layout tables (block table, tile gids, gid CSR, tail start, the
  tail region's per-word gids) and the save helpers
  (``tiles_for_blocks``, ``split_tail_blocks``, ``seg_bytes_for_blocks``)
  are equal;
- ``arena_drift_scores`` agrees within rtol 1e-5 (another summation
  order), and ``arena_restore`` restores the same values bit for bit.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import arena as ja
from repro.core.blocks import partition_pytree as j_partition
from repro_torch.core import arena as ta
from repro_torch.core.blocks import (WORD_DTYPE_NAMES, dtype_word_ratio,
                                     partition_pytree as t_partition,
                                     word_packable)
from repro_torch.interop import from_numpy_tree, to_numpy_tree
from repro_torch.utils.tree import tree_leaves

DTYPES = {"f32": np.float32, "bf16": ml_dtypes.bfloat16, "f16": np.float16,
          "e4m3": ml_dtypes.float8_e4m3fn, "e5m2": ml_dtypes.float8_e5m2,
          "i8": np.int8}


def _leaf(rng, shape, dtype):
    if np.dtype(dtype).kind in "iu":
        return rng.integers(-100, 100, shape).astype(dtype)
    return rng.normal(size=shape).astype(np.float32).astype(dtype)


def _tree(dtype, seed=0, mixed=False):
    """Multi-tile blocks, single-tile blocks, a tail leaf and a scalar."""
    rng = np.random.default_rng(seed)
    dts = list(DTYPES.values()) if mixed else [dtype] * 5
    return {"big": _leaf(rng, (40, 300), dts[0]),
            "emb": _leaf(rng, (33, 8), dts[1 % len(dts)]),
            "w": _leaf(rng, (50, 6), dts[2 % len(dts)]),
            "b": _leaf(rng, (5,), dts[3 % len(dts)]),
            "s": _leaf(rng, (), dts[4 % len(dts)])}


def _both(np_tree, block_rows=16):
    jt, tt = _to_jax(np_tree), from_numpy_tree(np_tree, "cpu")
    return (jt, tt, ja.build_arena_layout(j_partition(jt, block_rows)),
            ta.build_arena_layout(t_partition(tt, block_rows)))


def _to_jax(tree):
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    return jnp.asarray(tree)


def _bits(x):
    return np.asarray(x).view(np.int32)


def _raw(x):
    return np.asarray(x).reshape(-1).view(np.uint8)


CASES = [("f32", False), ("bf16", False), ("f16", False), ("e4m3", False),
         ("e5m2", False), ("i8", False), ("f32", True)]


@pytest.mark.parametrize("name,mixed", CASES)
def test_pack_arena_byte_equal(name, mixed):
    np_tree = _tree(DTYPES[name], mixed=mixed)
    jt, tt, jl, tl = _both(np_tree)
    got = ta.pack_arena(tt, tl)
    assert got.dtype == torch.int32 and got.numel() == tl.total_words
    np.testing.assert_array_equal(got.numpy(), _bits(ja.pack_arena(jt, jl)))
    back = to_numpy_tree(ta.unpack_arena(got, tl))
    for k, v in np_tree.items():
        assert back[k].dtype == v.dtype and back[k].shape == v.shape
        np.testing.assert_array_equal(_raw(back[k]), _raw(v))


@pytest.mark.parametrize("block_rows", [4, 16, 128])
@pytest.mark.parametrize("tail_pack", [True, False])
def test_layout_tables_equal(block_rows, tail_pack):
    np_tree = _tree(np.float32, mixed=True)
    jt, tt = _to_jax(np_tree), from_numpy_tree(np_tree, "cpu")
    jl = ja.build_arena_layout(j_partition(jt, block_rows),
                               tail_pack=tail_pack)
    tl = ta.build_arena_layout(t_partition(tt, block_rows),
                               tail_pack=tail_pack)
    assert [tuple(vars(b).values()) for b in tl.blocks] == \
        [tuple(vars(b).values()) for b in jl.blocks]
    for f in ("leaf_offset", "seg_words", "payload_words", "total_words",
              "tail_start", "leaf_order", "n_tiles", "has_tail"):
        assert getattr(tl, f) == getattr(jl, f), f
    assert tl.padding_ratio == pytest.approx(jl.padding_ratio, rel=1e-12)
    for f in ("ab_t0", "ab_nt", "gid_ab", "gid_ptr"):
        np.testing.assert_array_equal(getattr(tl, f), getattr(jl, f))
    np.testing.assert_array_equal(tl.tile_gids(), jl.tile_gids())
    # the tail region's per-word tables, and every main tile's dtype code,
    # agree with the reference's per-word tables
    wg, wc, dts = jl.word_tables()
    g, c = tl.tail_tables()
    np.testing.assert_array_equal(g, wg[tl.tail_start:])
    names = ["float32"] + [np.dtype(d).name for d in dts]
    main_code = wc[:tl.tail_start:ta.ARENA_TILE]
    want = [WORD_DTYPE_NAMES.index(names[k]) for k in main_code]
    np.testing.assert_array_equal(tl.tile_codes()[:tl.tail_start //
                                                  ta.ARENA_TILE], want)
    np.testing.assert_array_equal(
        c, [WORD_DTYPE_NAMES.index(names[k]) for k in wc[tl.tail_start:]])
    rng = np.random.default_rng(3)
    for _ in range(4):
        ids = rng.choice(tl.partition.total_blocks,
                         size=max(1, tl.partition.total_blocks // 3),
                         replace=False)
        np.testing.assert_array_equal(tl.tiles_for_blocks(ids),
                                      jl.tiles_for_blocks(ids))
        for a, b in zip(tl.split_tail_blocks(ids), jl.split_tail_blocks(ids)):
            np.testing.assert_array_equal(a, b)
        assert tl.seg_bytes_for_blocks(ids) == jl.seg_bytes_for_blocks(ids)


def test_colocated_layout_equal():
    rng = np.random.default_rng(5)
    net = {"a": rng.normal(size=(40, 12)).astype(np.float32),
           "b": rng.normal(size=(7,)).astype(np.float32)}
    tree = {"net": net, "mu": {k: v * 0.5 for k, v in net.items()},
            "nu": {k: v * 0.25 for k, v in net.items()}}
    col = ("net", "mu", "nu")
    jt, tt = _to_jax(tree), from_numpy_tree(tree, "cpu")
    jl = ja.build_arena_layout(j_partition(jt, 8, colocate=col))
    tl = ta.build_arena_layout(t_partition(tt, 8, colocate=col))
    np.testing.assert_array_equal(tl.gid_ab, jl.gid_ab)
    np.testing.assert_array_equal(tl.gid_ptr, jl.gid_ptr)
    np.testing.assert_array_equal(ta.pack_arena(tt, tl).numpy(),
                                  _bits(ja.pack_arena(jt, jl)))
    ids = [0, 3, int(tl.partition.total_blocks - 1)]
    assert tl.seg_bytes_for_blocks(ids) == jl.seg_bytes_for_blocks(ids)


@pytest.mark.parametrize("name,mixed", CASES)
def test_arena_drift_scores_match(name, mixed):
    np_tree = _tree(DTYPES[name], mixed=mixed)
    drift = _tree(DTYPES[name], seed=1, mixed=mixed)
    jt, tt, jl, tl = _both(np_tree)
    jz = {k: jnp.asarray(v) for k, v in drift.items()}
    tz = from_numpy_tree(drift, "cpu")
    want = np.asarray(ja.arena_drift_scores(
        ja.pack_arena(jt, jl), ja.pack_arena(jz, jl), jl))
    got = ta.arena_drift_scores(ta.pack_arena(tt, tl),
                                ta.pack_arena(tz, tl), tl)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


def test_arena_restore_matches():
    np_tree = _tree(np.float32, mixed=True)
    src = _tree(np.float32, seed=2, mixed=True)
    jt, tt, jl, tl = _both(np_tree)
    js = {k: jnp.asarray(v) for k, v in src.items()}
    mask = np.zeros((tl.partition.total_blocks,), bool)
    mask[::3] = True
    want = ja.arena_restore(jt, ja.pack_arena(js, jl), mask, jl)
    got = to_numpy_tree(ta.arena_restore(
        tt, ta.pack_arena(from_numpy_tree(src, "cpu"), tl), mask, tl))
    for k in np_tree:
        np.testing.assert_array_equal(_raw(got[k]), _raw(want[k]))


def test_word_helpers():
    assert all(word_packable(getattr(torch, n)) for n in WORD_DTYPE_NAMES
               if hasattr(torch, n))
    for dt in (torch.float64, torch.int64, torch.bool, torch.complex64):
        assert not word_packable(dt) and dtype_word_ratio(dt) == 1
    assert [dtype_word_ratio(d) for d in (torch.float32, torch.bfloat16,
                                          torch.float8_e4m3fn)] == [1, 2, 4]
    part = t_partition({"x": torch.zeros(4, 2, dtype=torch.float64)}, 2)
    assert not ta.arena_compatible(part)
    # a non-packable leaf keeps the f32-image convention on the way through
    x = torch.arange(8, dtype=torch.float64).reshape(4, 2)
    lay = ta.build_arena_layout(part)
    back = tree_leaves(ta.unpack_arena(ta.pack_arena({"x": x}, lay), lay))[0]
    assert back.dtype == torch.float64 and torch.equal(back, x)
