"""The port's kernels against the JAX package's Pallas kernels.

On the CPU each port wrapper runs its kernel's plain version (the tensors
lie on the CPU); the JAX side runs the Pallas kernel in interpret mode, as
the JAX package's own tests do. Copies are compared bit for bit, scores
within rtol 1e-5 (f32 sums in another order).

The CUDA kernels are held against their plain versions on the card by
``tests/test_torch_kernels_gpu.py``.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import blocks as jblocks
from repro.kernels.block_dist.kernel import block_dist_pallas
from repro.kernels.block_dist.ops import tree_block_scores as j_tree_scores
from repro.kernels.fused_maintain.kernel import scatter_save_pallas
from repro.kernels.fused_maintain.ops import \
    tree_scatter_save as j_tree_scatter_save
from repro.kernels.masked_restore.kernel import masked_restore_pallas
from repro.kernels.masked_restore.ops import \
    tree_masked_restore as j_tree_masked_restore
from repro_torch.core import blocks as tblocks
from repro_torch.core.norms import get_norm
from repro_torch.interop import from_numpy_tree, to_numpy_tree
from repro_torch.kernels.block_dist.ops import block_dist, tree_block_scores
from repro_torch.kernels.block_dist.ref import block_dist_ref
from repro_torch.kernels.fused_maintain.ops import (scatter_save,
                                                    tree_scatter_save)
from repro_torch.kernels.masked_restore.ops import (masked_restore,
                                                    tree_masked_restore)
from repro_torch.utils.tree import tree_leaves

NP_DTYPES = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16,
             "int32": np.int32}


def _values(rng, shape, dtype):
    if dtype == "int32":
        return rng.integers(-2**31, 2**31 - 1, size=shape, dtype=np.int32)
    return rng.normal(size=shape).astype(NP_DTYPES[dtype])


def _t(a):
    return from_numpy_tree(a, "cpu")


# -- block_dist ---------------------------------------------------------------

@pytest.mark.parametrize("n_blocks,elems", [(8, 512), (13, 700), (1, 37),
                                            (5, 1030)])
def test_block_dist_matches_pallas(n_blocks, elems):
    rng = np.random.default_rng(n_blocks * 1000 + elems)
    a = rng.normal(size=(n_blocks, elems)).astype(np.float32)
    b = rng.normal(size=(n_blocks, elems)).astype(np.float32)
    want = np.asarray(block_dist_pallas(jnp.asarray(a), jnp.asarray(b),
                                        interpret=True))
    got = block_dist(_t(a), _t(b))
    assert got.dtype == torch.float32 and got.shape == (n_blocks,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


def test_block_dist_is_the_l2_norm():
    rng = np.random.default_rng(0)
    a, b = (_t(rng.normal(size=(6, 40)).astype(np.float32)) for _ in "ab")
    assert torch.equal(get_norm("l2")(a, b, None), block_dist_ref(a, b))


# -- scatter_save ---------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
@pytest.mark.parametrize("rows,width,block_rows,ids", [
    (64, 24, 8, [0, 3, 3, 7]),        # duplicates
    (61, 24, 8, [7, 2, 7]),           # ragged last block, duplicated
    (10, 5, 4, [2]),                  # ragged only block selected
    (33, 128, 16, [2, 0, 1]),         # every block, ragged last
])
def test_scatter_save_matches_pallas(dtype, rows, width, block_rows, ids):
    rng = np.random.default_rng(rows * width)
    dst = _values(rng, (rows, width), dtype)
    src = _values(rng, (rows, width), dtype)
    ids_np = np.asarray(ids, np.int32)
    want = np.asarray(scatter_save_pallas(jnp.asarray(dst), jnp.asarray(src),
                                          jnp.asarray(ids_np), block_rows,
                                          interpret=True))
    d = _t(dst)
    out = scatter_save(d, _t(src), torch.from_numpy(ids_np), block_rows)
    assert out is d                                  # in place
    got = to_numpy_tree(out)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


# -- masked_restore ---------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("mask_kind", ["random", "all", "none"])
@pytest.mark.parametrize("n_blocks,elems", [(8, 512), (11, 300)])
def test_masked_restore_matches_pallas(dtype, mask_kind, n_blocks, elems):
    rng = np.random.default_rng(n_blocks + elems)
    dst = _values(rng, (n_blocks, elems), dtype)
    src = _values(rng, (n_blocks, elems), dtype)
    mask = {"random": rng.random(n_blocks) < 0.5,
            "all": np.ones(n_blocks, bool),
            "none": np.zeros(n_blocks, bool)}[mask_kind]
    want = np.asarray(masked_restore_pallas(jnp.asarray(dst),
                                            jnp.asarray(src),
                                            jnp.asarray(mask),
                                            interpret=True))
    got = masked_restore(_t(dst), _t(src), torch.from_numpy(mask)).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
@pytest.mark.parametrize("rows,width,block_rows", [
    (196, 10, 128),                   # MLR's w at the default block_rows
    (10, 1, 128),                     # MLR's b: one block, shorter than it
    (61, 24, 8),                      # ragged last block
    (64, 3, 16),                      # whole blocks
])
def test_masked_restore_rows_matches_pallas(dtype, rows, width, block_rows):
    # The port restores a leaf's raw (R, W) rows by blocks of block_rows;
    # the reference runs the Pallas kernel on the zero-padded
    # (n_blocks, E) view and cuts the padding off.
    rng = np.random.default_rng(rows * width + block_rows)
    dst = _values(rng, (rows, width), dtype)
    src = _values(rng, (rows, width), dtype)
    n_blocks = -(-rows // block_rows)
    mask = rng.random(n_blocks) < 0.5
    mask[-1] = True
    view = lambda x: jblocks.leaf_block_view(jnp.asarray(x), block_rows)
    want = masked_restore_pallas(view(dst), view(src), jnp.asarray(mask),
                                 interpret=True)
    want = np.asarray(want).reshape(-1, width)[:rows]
    got = to_numpy_tree(masked_restore(_t(dst), _t(src),
                                       torch.from_numpy(mask), block_rows))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


# -- tree-level wrappers -------------------------------------------------------

def _tree(rng):
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    return {"w": f(37, 6), "emb": f(64, 4), "b": f(6), "s": f(),
            "q": rng.integers(-100, 100, size=(18, 3), dtype=np.int32)}


def test_tree_scatter_save_matches_reference():
    rng = np.random.default_rng(3)
    dst, src = _tree(rng), _tree(rng)
    br = 8
    jt = jax.tree_util.tree_map(jnp.asarray, dst)
    jp = jblocks.partition_pytree(jt, br)
    tp = tblocks.partition_pytree(_t(dst), br)
    idx = np.asarray([0, 4, 4, 9, 12, tp.total_blocks - 1], np.int64)
    want, want_moved = j_tree_scatter_save(
        jt, jax.tree_util.tree_map(jnp.asarray, src), idx, jp)
    got, moved = tree_scatter_save(_t(dst), _t(src), idx, tp)
    assert moved == want_moved
    for g, w in zip(tree_leaves(to_numpy_tree(got)),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_tree_scatter_save_rejects_bad_ids():
    rng = np.random.default_rng(4)
    t = _t(_tree(rng))
    part = tblocks.partition_pytree(t, 8)
    with pytest.raises(IndexError):
        tree_scatter_save(t, t, [part.total_blocks], part)


def test_tree_masked_restore_matches_reference():
    rng = np.random.default_rng(5)
    dst, src = _tree(rng), _tree(rng)
    br = 8
    jt = jax.tree_util.tree_map(jnp.asarray, dst)
    jp = jblocks.partition_pytree(jt, br)
    tp = tblocks.partition_pytree(_t(dst), br)
    mask = rng.random(jp.total_blocks) < 0.5
    want = j_tree_masked_restore(jt, jax.tree_util.tree_map(jnp.asarray, src),
                                 jnp.asarray(mask), jp, interpret=True)
    got = tree_masked_restore(_t(dst), _t(src), torch.from_numpy(mask), tp)
    for g, w in zip(tree_leaves(to_numpy_tree(got)),
                    jax.tree_util.tree_leaves(want)):
        assert g.dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g, np.asarray(w))


def test_tree_block_scores_matches_reference():
    rng = np.random.default_rng(6)
    a, b = _tree(rng), _tree(rng)
    br = 8
    ja = jax.tree_util.tree_map(jnp.asarray, a)
    jp = jblocks.partition_pytree(ja, br)
    tp = tblocks.partition_pytree(_t(a), br)
    want = j_tree_scores(ja, jax.tree_util.tree_map(jnp.asarray, b), jp,
                         interpret=True)
    got = tree_block_scores(_t(a), _t(b), tp)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


def test_tree_block_scores_accumulates_colocated_leaves():
    # The reference's tree_block_scores concatenates per leaf, which gives
    # more than total_blocks scores under colocate; the port accumulates
    # by offset, as block_scores does, and is held to block_scores.
    rng = np.random.default_rng(8)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    net = {"w": f(20, 3), "b": f(3)}
    a = {"net": net, "mu": {k: f(*v.shape) for k, v in net.items()}}
    b = jax.tree_util.tree_map(lambda x: x + f(*x.shape), a)
    ja = jax.tree_util.tree_map(jnp.asarray, a)
    jp = jblocks.partition_pytree(ja, 8, colocate=("net", "mu"))
    tp = tblocks.partition_pytree(_t(a), 8, colocate=("net", "mu"))
    want = jblocks.block_scores(ja, jax.tree_util.tree_map(jnp.asarray, b),
                                jp, lambda x, y, l: jnp.sum((x - y) ** 2, -1))
    got = tree_block_scores(_t(a), _t(b), tp)
    assert got.shape == (tp.total_blocks,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    concat = j_tree_scores(ja, jax.tree_util.tree_map(jnp.asarray, b), jp,
                           interpret=True)
    assert concat.shape[0] > tp.total_blocks


def test_score_fn_hook_gives_the_default_save_masks():
    from repro_torch.core.controller import FTController
    from repro_torch.core.policy import CheckpointPolicy
    from repro_torch.kernels.block_dist.ops import make_score_fn
    rng = np.random.default_rng(9)
    p0 = _t(_tree(rng))
    policy = CheckpointPolicy(fraction=0.3, full_interval=3, block_rows=8)
    plain = FTController(p0, policy, device="cpu")
    hooked = FTController(p0, policy, device="cpu",
                          score_fn=make_score_fn(plain.partition))
    for step in range(1, 4):
        p = _t(_tree(rng))
        assert torch.equal(plain.checkpoint_now(step, p),
                           hooked.checkpoint_now(step, p))
