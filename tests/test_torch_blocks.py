"""The port's block partition and block ops against the JAX package's.

Inputs are made once with numpy from a seed and handed to both packages.
Block tables and selections are compared bit for bit; scores, whose sums
run in another order in torch, within rtol 1e-5.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import blocks as jblocks
from repro.core import norms as jnorms
from repro.core.checkpoint import select_save_mask as j_select_save_mask
from repro.core.checkpoint import init_running_checkpoint as j_init_ckpt
from repro.core.policy import CheckpointPolicy as JPolicy
from repro_torch.core import blocks as tblocks
from repro_torch.core import norms as tnorms
from repro_torch.core.checkpoint import (init_running_checkpoint,
                                         select_save_mask, top_k_indices)
from repro_torch.core.policy import CheckpointPolicy
from repro_torch.interop import from_numpy_tree, to_numpy_tree
from repro_torch.utils.tree import tree_leaves


def _np_trees():
    rng = np.random.default_rng(7)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    unordered = {"zeta": f(21, 3), "alpha": {"y": f(17, 2, 2), "b": f(5)},
                 "mid": [f(9, 4), (f(3), f())]}
    nested = {"layer": {"w": f(40, 6), "b": f(6)}, "emb": f(33, 8),
              "scalar": f()}
    net = {"fc": f(19, 4), "bias": f(4)}
    coloc = {"net": net,
             "mu": {k: f(*v.shape) for k, v in net.items()},
             "nu": {k: f(*v.shape) for k, v in net.items()},
             "t": np.asarray(3, np.int32)}
    return {"unordered": (unordered, ()), "nested": (nested, ()),
            "colocate": (coloc, ("net", "mu", "nu"))}


TREES = _np_trees()


def _table(partition):
    return [(l.name, tuple(l.shape), l.rows, l.row_width, l.n_blocks,
             l.offset) for l in partition.leaves]


def _gid_map(partition):
    return {(l.name, j): l.offset + j for l in partition.leaves
            for j in range(l.n_blocks)}


@pytest.mark.parametrize("tree_name", sorted(TREES))
@pytest.mark.parametrize("block_rows", [4, 8, 16])
def test_block_tables_identical(tree_name, block_rows):
    tree, coloc = TREES[tree_name]
    jp = jblocks.partition_pytree(jax.tree_util.tree_map(jnp.asarray, tree),
                                  block_rows, colocate=coloc)
    tp = tblocks.partition_pytree(from_numpy_tree(tree, "cpu"), block_rows,
                                  colocate=coloc)
    assert _table(tp) == _table(jp)
    assert _gid_map(tp) == _gid_map(jp)
    assert tp.total_blocks == jp.total_blocks
    assert tp.total_params == jp.total_params
    assert tp.blocks_for_k(0.3) == jp.blocks_for_k(0.3)


def test_insertion_order_does_not_renumber():
    rng = np.random.default_rng(1)
    a, b = rng.normal(size=(9, 2)), rng.normal(size=(5,))
    t1 = tblocks.partition_pytree(from_numpy_tree({"b": b, "a": a}, "cpu"), 4)
    t2 = tblocks.partition_pytree(from_numpy_tree({"a": a, "b": b}, "cpu"), 4)
    assert _table(t1) == _table(t2)
    assert [l.name for l in t1.leaves] == ["['a']", "['b']"]


def _both(tree_name, block_rows):
    tree, coloc = TREES[tree_name]
    jt = jax.tree_util.tree_map(jnp.asarray, tree)
    tt = from_numpy_tree(tree, "cpu")
    return (jt, jblocks.partition_pytree(jt, block_rows, colocate=coloc),
            tt, tblocks.partition_pytree(tt, block_rows, colocate=coloc))


def _other(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + rng.normal(size=np.shape(x)))
        .astype(np.asarray(x).dtype), tree)


@pytest.mark.parametrize("tree_name", sorted(TREES))
def test_select_split_expand_bit_equal(tree_name):
    br = 4
    jt, jp, tt, tp = _both(tree_name, br)
    src_np = _other(TREES[tree_name][0], 3)
    mask_np = np.random.default_rng(5).random(jp.total_blocks) < 0.5
    jm, tm = jnp.asarray(mask_np), torch.from_numpy(mask_np)
    for js, ts in zip(jblocks.split_global_mask(jm, jp),
                      tblocks.split_global_mask(tm, tp)):
        np.testing.assert_array_equal(np.asarray(js), ts.numpy())
    for leaf_j, leaf_t, js, ts in zip(jp.leaves, tp.leaves,
                                      jblocks.split_global_mask(jm, jp),
                                      tblocks.split_global_mask(tm, tp)):
        np.testing.assert_array_equal(
            np.asarray(jblocks.expand_block_mask(js, leaf_j, br)),
            tblocks.expand_block_mask(ts, leaf_t, br).numpy())
    got = tblocks.select_blocks(tt, from_numpy_tree(src_np, "cpu"), tm, tp)
    want = jblocks.select_blocks(
        jt, jax.tree_util.tree_map(jnp.asarray, src_np), jm, jp)
    for g, w in zip(tree_leaves(to_numpy_tree(got)),
                    jax.tree_util.tree_leaves(want)):
        assert g.dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("norm", ["l2", "l1", "linf", "scaled_tv"])
@pytest.mark.parametrize("tree_name", sorted(TREES))
def test_block_scores_agree(norm, tree_name):
    br = 4
    jt, jp, tt, tp = _both(tree_name, br)
    other = _other(TREES[tree_name][0], 11)
    first = jp.leaves[0]
    aux = {first.name: np.arange(1, first.rows + 1, dtype=np.float32)}
    want = jblocks.block_scores(
        jt, jax.tree_util.tree_map(jnp.asarray, other), jp,
        jnorms.get_norm(norm, aux=aux, block_rows=br))
    got = tblocks.block_scores(
        tt, from_numpy_tree(other, "cpu"), tp,
        tnorms.get_norm(norm, aux=aux, block_rows=br))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("tree_name", sorted(TREES))
def test_sq_norms_agree(tree_name):
    jt, jp, tt, tp = _both(tree_name, 4)
    other = _other(TREES[tree_name][0], 13)
    mask_np = np.random.default_rng(2).random(jp.total_blocks) < 0.4
    jo, to = jax.tree_util.tree_map(jnp.asarray, other), from_numpy_tree(
        other, "cpu")
    np.testing.assert_allclose(
        float(tblocks.masked_sq_norm(tt, to, torch.from_numpy(mask_np), tp)),
        float(jblocks.masked_sq_norm(jt, jo, jnp.asarray(mask_np), jp)),
        rtol=1e-5)
    np.testing.assert_allclose(float(tblocks.tree_sq_norm(tt, to)),
                               float(jblocks.tree_sq_norm(jt, jo)), rtol=1e-5)


def test_interop_round_trip_keeps_keys_dtypes_and_bits():
    rng = np.random.default_rng(4)
    tree = {"b": [rng.normal(size=(3, 2)).astype(ml_dtypes.bfloat16),
                  (np.asarray(7, np.int32),)],
            "a": rng.normal(size=(5,)).astype(np.float32)}
    back = to_numpy_tree(from_numpy_tree(tree, "cpu"))
    assert list(back) == ["a", "b"] and isinstance(back["b"], list) \
        and isinstance(back["b"][1], tuple)
    for got, want in zip(jax.tree_util.tree_leaves(back),
                         jax.tree_util.tree_leaves(tree)):
        assert got.dtype == want.dtype and got.shape == np.shape(want)
        assert got.tobytes() == np.asarray(want).tobytes()


def test_top_k_ties_go_to_lower_index():
    scores = [1.0, 3.0, 3.0, 0.0, 3.0, 2.0]
    _, want = jax.lax.top_k(jnp.asarray(scores, jnp.float32), 3)
    got = top_k_indices(torch.tensor(scores), 3)
    assert got.tolist() == np.asarray(want).tolist() == [1, 2, 4]


def test_priority_save_mask_with_tied_scores_matches_reference():
    # seven single-row blocks whose scores tie at the k-th place
    tree = {"x": np.zeros((7, 1), np.float32)}
    scores = np.asarray([0.5, 2.0, 1.0, 2.0, 1.0, 1.0, 0.0], np.float32)
    jpol, tpol = JPolicy(fraction=0.5, block_rows=1), \
        CheckpointPolicy(fraction=0.5, block_rows=1)
    jt = jax.tree_util.tree_map(jnp.asarray, tree)
    jp = jblocks.partition_pytree(jt, 1)
    tt = from_numpy_tree(tree, "cpu")
    tp = tblocks.partition_pytree(tt, 1)
    jm, _ = j_select_save_mask(j_init_ckpt(jt, jp), jt, policy=jpol,
                               partition=jp, norm_fn=None,
                               scores=jnp.asarray(scores))
    tm, _ = select_save_mask(init_running_checkpoint(tt, tp), tt,
                             policy=tpol, partition=tp, norm_fn=None,
                             scores=torch.from_numpy(scores))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert np.nonzero(tm.numpy())[0].tolist() == [1, 2, 3, 4]
