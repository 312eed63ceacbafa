"""The grouped whole-tree kernels' tables and walks, emulated on the CPU.

``csrc/block_dist.cu`` (``block_dist_tree_f32``),
``csrc/scatter_save.cu`` (``scatter_save_tree_bytes``) and
``csrc/masked_restore.cu`` (``masked_restore_tree_bytes``) run a whole tree
in one launch over the tables of ``repro_torch/kernels/leaf_table.py``.
This file builds those tables from CPU tensors, walks them in numpy as the
kernels do, reading and writing through the addresses the tables hold
(ctypes), and holds the result against the reference:

- block_dist: one CTA per work item (256 threads, float4 or scalar reads
  as the item's leaf allows, a bf16 pair read in place as four values a
  load, warp shuffles, the CTA's fixed-order sum),
  then one warp per global block summing its segments in leaf order,
  against ``repro.core.blocks.block_scores`` under l2 (rtol 1e-5);
- scatter_save: the pair list from global ids, one item per chunk of a
  pair's block, the carrier width chosen per pair from its addresses and
  length, against ``repro.kernels.fused_maintain.ops.tree_scatter_save``
  on its jnp path (bit-exact);
- masked_restore: one item per chunk of every (leaf, block), the block's
  mask bit read at the leaf's global offset, the carrier chosen per item,
  against ``repro.kernels.masked_restore.ops.tree_masked_restore`` (its
  Pallas kernel in interpret mode; f64 leaves under ``jax.enable_x64``)
  and, with an arena as the source (segments read in place with their
  pitch, a leaf of another dtype through its decoded copy), against
  ``repro.core.arena.arena_restore`` (bit-exact).

||delta||^2 at recovery (``perturbation_norms``, ``applied_sq``) is the
sum of one grouped block_dist pass, held to the reference within rtol
1e-4.

The tree has ragged, single-block, 0-d, bf16, uint8 and colocated leaves
(the CNN's ``colocate=("net", "mu", "nu")`` shape) and leaves that are
views at odd offsets (masked_restore's adds int8 and f64 leaves). Small
chunk sizes give blocks of several chunks.
The same walks run on the card in ``tests/test_torch_kernels_gpu.py``.
"""
import copy
import ctypes
import gc

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import blocks as jblocks
from repro.core import norms as jnorms
from repro.core import arena as jarena
from repro.core import recovery as jrecovery
from repro.core.checkpoint import RunningCheckpoint as JCheckpoint
from repro.core.policy import RecoveryMode as JMode
from repro.kernels.fused_maintain.ops import \
    tree_scatter_save as j_tree_scatter_save
from repro.kernels.masked_restore.ops import \
    tree_masked_restore as j_tree_masked_restore
from repro_torch.core import arena as tarena
from repro_torch.core import recovery as trecovery
from repro_torch.core import blocks as tblocks
from repro_torch.core.norms import get_norm
from repro_torch.kernels import leaf_table as lt
from repro_torch.kernels.block_dist import kernel as bkernel
from repro_torch.kernels.block_dist import ops as bops
from repro_torch.kernels.fused_maintain import ops as fops
from repro_torch.kernels.masked_restore import kernel as mkernel
from repro_torch.kernels.masked_restore import ops as mops
from repro_torch.core.checkpoint import RunningCheckpoint as TCheckpoint
from repro_torch.core.policy import RecoveryMode as TMode
from repro_torch.utils.tree import tree_flatten, tree_leaves

THREADS = 256          # block_dist.cu kThreads; byte_copy.cuh kCopyThreads
BR = 8
COLOCATE = ("net", "mu", "nu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the tree
# ---------------------------------------------------------------------------

def np_tree(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    net = {"conv": f(37, 3, 4), "bias": f(5), "fc": f(20, 300)}
    return {
        "net": net,
        "mu": {k: f(*v.shape) for k, v in net.items()},
        "nu": {k: f(*v.shape) for k, v in net.items()},
        "x": {"big": f(300, 6), "even": f(64, 8), "scalar": f(),
              "half": rng.normal(size=(40, 12)).astype(ml_dtypes.bfloat16),
              "odd": f(45, 3), "bytes": rng.integers(
                  0, 256, size=(33, 5), dtype=np.uint8)},
    }


def _odd_view(a: np.ndarray, pad_elems: int) -> torch.Tensor:
    """A contiguous tensor with ``a``'s values that is a view into a larger
    buffer at ``pad_elems`` elements from its start."""
    flat = torch.from_numpy(np.ascontiguousarray(a).reshape(-1).copy())
    buf = torch.zeros((pad_elems + flat.numel(),), dtype=flat.dtype)
    buf[pad_elems:] = flat
    return buf[pad_elems:].view(a.shape)


def port_leaf(v: np.ndarray) -> torch.Tensor:
    if v.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(v.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(v))


def port_tree(t: dict) -> dict:
    """The port's tree of the same values; ``x.odd`` (f32) starts 4 bytes
    and ``x.bytes`` (uint8) 1 byte past an aligned address."""
    out = {k: {n: port_leaf(v) for n, v in sub.items()}
           for k, sub in t.items()}
    out["x"]["odd"] = _odd_view(t["x"]["odd"], 1)
    out["x"]["bytes"] = _odd_view(t["x"]["bytes"], 1)
    return out


def jax_tree(t: dict) -> dict:
    return jax.tree_util.tree_map(jnp.asarray, t)


def partitions(t: dict):
    return (jblocks.partition_pytree(jax_tree(t), BR, colocate=COLOCATE),
            tblocks.partition_pytree(port_tree(t), BR, colocate=COLOCATE))


def _bytes(t: torch.Tensor) -> bytes:
    return t.reshape(-1).view(torch.uint8).numpy().tobytes()


def _view(ptr: int, n: int, ctype) -> np.ndarray:
    """``n`` values of ``ctype`` at address ``ptr``, as a numpy array."""
    if n == 0:
        return np.zeros((0,), np.dtype(ctype))
    return np.ctypeslib.as_array((ctype * n).from_address(ptr))


def _bf16_as_f32(bits: np.ndarray) -> np.ndarray:
    """bf16 values given as their 16 bits, widened exactly to f32."""
    return (bits.astype(np.uint32) << 16).view(np.float32)


def test_tree_has_the_cases():
    t = np_tree(0)
    _, tp = partitions(t)
    pt = port_tree(t)
    meta = {l.name: l for l in tp.leaves}
    leaves = dict(zip((l.name for l in tp.leaves), tree_leaves(pt)))
    assert meta["['x']['big']"].rows % BR and meta["['x']['big']"].n_blocks > 1
    assert meta["['net']['bias']"].n_blocks == 1
    assert meta["['x']['scalar']"].shape == ()
    assert leaves["['x']['half']"].dtype == torch.bfloat16
    assert leaves["['x']['odd']"].data_ptr() % 16 == 4
    assert leaves["['x']['bytes']"].data_ptr() % 2 == 1
    assert meta["['mu']['fc']"].offset == meta["['net']['fc']"].offset
    assert meta["['nu']['conv']"].offset == meta["['mu']['conv']"].offset


# ---------------------------------------------------------------------------
# block_dist
# ---------------------------------------------------------------------------

def warp_sum(v: np.ndarray) -> np.float32:
    """Lane 0 of ``__shfl_down_sync`` folding (16, 8, 4, 2, 1)."""
    v = v.astype(np.float32).copy()
    for off in (16, 8, 4, 2, 1):
        v[:32 - off] = v[:32 - off] + v[off:]
    return v[0]


def cta_chunk(a: np.ndarray, b: np.ndarray, lo: int, hi: int,
              vec: bool) -> np.float32:
    """``chunk_sq_dist`` on every thread, then ``cta_sum``."""
    acc = np.zeros((THREADS,), np.float32)

    def fold(t0, x, y):
        d = x - y
        acc[t0:t0 + d.size] = acc[t0:t0 + d.size] + d * d

    if hi > lo:
        start = lo
        if vec:
            q_lo, q_hi = lo // 4, hi // 4
            x4 = a[4 * q_lo:4 * q_hi].reshape(-1, 4)
            y4 = b[4 * q_lo:4 * q_hi].reshape(-1, 4)
            for s in range(0, len(x4), THREADS):
                for c in range(4):
                    fold(0, x4[s:s + THREADS, c], y4[s:s + THREADS, c])
            start = 4 * q_hi
        for s in range(start, hi, THREADS):
            fold(0, a[s:min(s + THREADS, hi)], b[s:min(s + THREADS, hi)])
    parts = [warp_sum(acc[w * 32:(w + 1) * 32]) for w in range(THREADS // 32)]
    total = np.float32(0)
    for p in parts:
        total = np.float32(total + p)
    return total


def emulate_block_dist(table: lt.BlockDistTable, ptrs: list,
                       chunk: int) -> np.ndarray:
    """The grouped kernel's two passes over ``table`` and the pointer
    column ``ptrs``."""
    partials = np.zeros((table.n_items,), np.float32)
    for g in range(table.n_items):
        l = int(table.item_leaf[g])
        cpb, be, numel = (int(table.cpb[l]), int(table.block_elems[l]),
                          table.numel[l])
        local = g - int(table.item_start[l])
        k = local // cpb
        lo = k * be + (local - k * cpb) * chunk
        hi = min(lo + chunk, k * be + be, numel)
        pa, pb = ptrs[2 * l], ptrs[2 * l + 1]
        if pa & lt.BF16_FLAG:
            # a bf16 pair, read in place: 8-byte loads of four values
            pa, pb = pa & ~lt.BF16_FLAG, pb & ~lt.BF16_FLAG
            vec = ((pa | pb) & 7) == 0 and be % 4 == 0
            xa, xb = (_bf16_as_f32(_view(p, numel, ctypes.c_uint16))
                      for p in (pa, pb))
        else:
            vec = ((pa | pb) & 15) == 0 and be % 4 == 0
            xa, xb = (_view(p, numel, ctypes.c_float) for p in (pa, pb))
        partials[g] = cta_chunk(xa, xb, lo, hi, vec)
    out = np.zeros((table.total_blocks,), np.float32)
    for j in range(table.total_blocks):
        acc = np.float32(0)
        for s in range(table.seg_start[j], table.seg_start[j + 1]):
            first, count = int(table.seg_first[s]), int(table.seg_count[s])
            lanes = np.zeros((32,), np.float32)
            for c in range(count):
                lanes[c % 32] = lanes[c % 32] + partials[first + c]
            acc = np.float32(acc + warp_sum(lanes))
        out[j] = acc
    return out


def test_block_dist_table_covers_every_value_once():
    _, tp = partitions(np_tree(1))
    for chunk in (lt.BLOCK_DIST_CHUNK, 64, 12):
        t = lt.block_dist_table(tp, chunk)
        seen = [np.zeros((n,), np.int64) for n in t.numel]
        for g in range(t.n_items):
            l = int(t.item_leaf[g])
            local = g - int(t.item_start[l])
            k, c = divmod(local, int(t.cpb[l]))
            be = int(t.block_elems[l])
            lo = k * be + c * chunk
            seen[l][lo:min(lo + chunk, k * be + be, t.numel[l])] += 1
        assert all(np.all(s == 1) for s in seen)
        # each global block's segments: one per leaf holding it, leaf order
        want = [[] for _ in range(t.total_blocks)]
        for i, leaf in enumerate(tp.leaves):
            for k in range(leaf.n_blocks):
                want[leaf.offset + k].append(
                    (int(t.item_start[i]) + k * int(t.cpb[i]),
                     int(t.cpb[i])))
        got = [list(zip(t.seg_first[a:b].tolist(), t.seg_count[a:b].tolist()))
               for a, b in zip(t.seg_start[:-1], t.seg_start[1:])]
        assert got == want
    assert lt.block_dist_table(tp) is lt.block_dist_table(tp)   # cached


def test_tables_are_cached_per_partition_object():
    """A copy of a partition builds its own tables, and a partition's
    tables go with it."""
    _, tp = partitions(np_tree(1))
    twin = copy.copy(tp)
    assert twin == tp and lt.block_dist_table(twin) is not \
        lt.block_dist_table(tp)
    key = id(twin)
    assert key in lt._PER_PARTITION
    del twin
    gc.collect()
    assert key not in lt._PER_PARTITION
    assert not hasattr(tp, "memo")


def test_block_dist_kernel_refuses_a_table_of_another_chunk():
    ta = np_tree(4)
    _, tp = partitions(ta)
    a = tree_leaves(port_tree(ta))
    with pytest.raises(ValueError, match="chunks"):
        bkernel.block_dist_tree_cuda(a, a, lt.block_dist_table(tp, 64))


@pytest.mark.parametrize("chunk", [lt.BLOCK_DIST_CHUNK, 64, 12])
def test_block_dist_walk_matches_reference(chunk):
    ta, tb = np_tree(2), np_tree(3)
    jp, tp = partitions(ta)
    want = np.asarray(jblocks.block_scores(
        jax_tree(ta), jax_tree(tb), jp, jnorms.get_norm("l2")))
    a, b = tree_leaves(port_tree(ta)), tree_leaves(port_tree(tb))
    table = lt.block_dist_table(tp, chunk)
    ptrs, keep = lt.dist_pointers(a, b, table)
    # the f32 leaves are read in place, views included, and the bf16 pair
    # too (its addresses flagged); the uint8 pair through f32 copies
    assert len(keep) == 2
    names = [l.name for l in tp.leaves]
    assert ptrs[2 * names.index("['x']['odd']")] \
        == a[names.index("['x']['odd']")].data_ptr()
    half = names.index("['x']['half']")
    assert ptrs[2 * half] == a[half].data_ptr() | lt.BF16_FLAG
    assert ptrs[2 * half + 1] == b[half].data_ptr() | lt.BF16_FLAG
    got = emulate_block_dist(table, ptrs, chunk)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # the plain version the CPU route takes agrees as well
    plain = bops.tree_block_dist(a, b, tp).numpy()
    np.testing.assert_allclose(got, plain, rtol=1e-5)


def test_block_dist_pointers_refuse_a_wrong_leaf():
    ta = np_tree(4)
    _, tp = partitions(ta)
    a = tree_leaves(port_tree(ta))
    table = lt.block_dist_table(tp)
    with pytest.raises(ValueError):
        lt.dist_pointers(a[:-1], a[:-1], table)
    with pytest.raises(ValueError):
        lt.dist_pointers(a, a[:1] + [a[0]] + a[2:], table)


def test_l2_block_scores_take_the_tree_form(monkeypatch):
    """block_scores under l2 hands the whole tree to the norm's tree form
    (one call), and the other norms keep the per-leaf padded views."""
    ta, tb = np_tree(5), np_tree(6)
    jp, tp = partitions(ta)
    a, b = port_tree(ta), port_tree(tb)
    calls = []
    real = bops.tree_block_dist

    def counting(al, bl, part):
        calls.append(len(al))
        return real(al, bl, part)

    l2 = get_norm("l2", block_rows=BR)
    monkeypatch.setattr(l2, "tree", counting)
    got = tblocks.block_scores(a, b, tp, l2)
    assert calls == [len(tp.leaves)]
    want = jblocks.block_scores(jax_tree(ta), jax_tree(tb), jp,
                                jnorms.get_norm("l2"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


@pytest.mark.parametrize("norm", ["l1", "linf", "scaled_tv"])
def test_other_norms_keep_the_padded_views(norm):
    ta, tb = np_tree(7), np_tree(8)
    jp, tp = partitions(ta)
    tn = get_norm(norm, block_rows=BR)
    assert getattr(tn, "tree", None) is None
    got = tblocks.block_scores(port_tree(ta), port_tree(tb), tp, tn)
    want = jblocks.block_scores(jax_tree(ta), jax_tree(tb), jp,
                                jnorms.get_norm(norm, block_rows=BR))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


def test_masked_sq_norm_matches_reference():
    ta, tb = np_tree(9), np_tree(10)
    jp, tp = partitions(ta)
    mask = np.random.default_rng(11).random(tp.total_blocks) < 0.4
    got = tblocks.masked_sq_norm(port_tree(ta), port_tree(tb),
                                 torch.from_numpy(mask), tp)
    want = jblocks.masked_sq_norm(jax_tree(ta), jax_tree(tb),
                                  jnp.asarray(mask), jp)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    per_block = bops.tree_block_scores(port_tree(ta), port_tree(tb), tp)
    assert float(tblocks.masked_total(per_block, torch.from_numpy(mask))) \
        == float(got)


# ---------------------------------------------------------------------------
# scatter_save
# ---------------------------------------------------------------------------

def emulate_scatter_save(t: lt.ScatterTable, chunk: int) -> list:
    """The grouped kernel over ``t``: each item copies its chunk through the
    table's addresses with the pair's carrier. Returns the carriers."""
    rows = t.table[:t.pairs_at].reshape(-1, 4)
    pairs = t.table[t.pairs_at:t.items_at].reshape(-1, 3)
    item_pair = t.table[t.items_at:].view(np.int32)[:t.n_items]
    widths = []
    for g in range(t.n_items):
        leaf, b, first = (int(v) for v in pairs[item_pair[g]])
        dst, src, block_bytes, total = (int(v) for v in rows[leaf])
        block_lo = b * block_bytes
        length = min(block_lo + block_bytes, total) - block_lo
        lo = (g - first) * chunk
        hi = min(lo + chunk, length)
        if b < 0 or lo >= hi:
            continue
        bits = (dst + block_lo) | (src + block_lo) | length | 16
        w = bits & -bits
        assert lo % w == 0 and hi % w == 0
        widths.append(w)
        _view(dst + block_lo + lo, hi - lo, ctypes.c_uint8)[:] = \
            _view(src + block_lo + lo, hi - lo, ctypes.c_uint8)
    return widths


def test_save_pairs_expand_colocated_ids():
    _, tp = partitions(np_tree(12))
    idx = np.unique(np.random.default_rng(13).integers(
        0, tp.total_blocks, 12)).astype(np.int64)
    leaf, block = lt.save_pairs(idx, tp)
    want = [(i, int(g - l.offset)) for i, l in enumerate(tp.leaves)
            for g in idx if l.offset <= g < l.offset + l.n_blocks]
    assert list(zip(leaf.tolist(), block.tolist())) == want
    shared = [i for i, l in enumerate(tp.leaves)
              if l.offset == tp.leaves[0].offset]
    assert len(shared) == 3                   # mu, net, nu share block ids


@pytest.mark.parametrize("chunk", [lt.COPY_CHUNK_BYTES, 64])
def test_scatter_save_walk_matches_reference(chunk):
    td, ts = np_tree(14), np_tree(15)
    jp, tp = partitions(td)
    idx = np.unique(np.random.default_rng(16).integers(
        0, tp.total_blocks, 20)).astype(np.int64)
    # every leaf's first and last block, and a seeded few
    idx = np.union1d(idx, [g for l in tp.leaves
                           for g in (l.offset, l.offset + l.n_blocks - 1)])
    want, want_moved = j_tree_scatter_save(jax_tree(td), jax_tree(ts), idx,
                                           jp)
    dst, src = port_tree(td), port_tree(ts)
    dst_flat, _ = tree_flatten(dst)
    leaf, block = lt.save_pairs(idx, tp)
    t = lt.scatter_table(dst_flat, tree_leaves(src), leaf, block, tp, chunk)
    widths = emulate_scatter_save(t, chunk)
    assert {1, 4, 16} <= set(widths)          # odd views and aligned leaves
    for g, w in zip(dst_flat, jax.tree_util.tree_leaves(want)):
        assert _bytes(g) == np.asarray(w).tobytes()
    # the CPU route of tree_scatter_save gives the same bytes and count
    out, moved = fops.tree_scatter_save(port_tree(td), src, idx, tp)
    assert moved == want_moved
    assert [_bytes(g) for g in tree_leaves(out)] == \
        [_bytes(g) for g in dst_flat]


def test_scatter_table_refuses_bad_pairs():
    td = np_tree(17)
    _, tp = partitions(td)
    dst = tree_leaves(port_tree(td))
    c = [l.name for l in tp.leaves].index("['mu']['conv']")
    with pytest.raises(IndexError):
        lt.scatter_table(dst, dst, np.array([c]),
                         np.array([tp.leaves[c].n_blocks]), tp)
    strided = list(dst)
    strided[c] = dst[c].transpose(0, 1)           # (37, 3, 4) -> (3, 37, 4)
    with pytest.raises(ValueError):
        lt.scatter_table(strided, dst, np.array([c]), np.array([0]), tp)


# ---------------------------------------------------------------------------
# ||delta'||^2 per tier at recovery (the per-block distances computed once)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_failed", [2, 3])
def test_tier_sq_matches_reference(n_failed):
    """Four drift steps of maintain + PRIORITY 1/8 saves under the default
    fabric, then the loss of block 0's primary and replica homes (and one
    more device): tier counts exact, every tier's ||delta'||^2 within rtol
    1e-4 of the reference's, PEER_REPLICA and PARITY exactly 0."""
    from repro.core.controller import FTController as JController
    from repro.core.policy import CheckpointPolicy as JPolicy
    from repro.core.policy import SelectionStrategy as JStrategy
    from repro.fabric import FabricConfig as JFabricConfig
    from repro_torch.core.controller import FTController as TController
    from repro_torch.core.policy import CheckpointPolicy as TPolicy
    from repro_torch.core.policy import SelectionStrategy as TStrategy
    from repro_torch.fabric import FabricConfig as TFabricConfig
    from repro_torch.interop import from_numpy_tree

    rng = np.random.default_rng(18)
    tree = {"big": rng.normal(size=(64, 300)).astype(np.float32),
            "w": rng.normal(size=(96, 12)).astype(np.float32),
            "b": rng.normal(size=(5,)).astype(np.float32)}
    jt = {k: jnp.asarray(v) for k, v in tree.items()}
    tt = from_numpy_tree(tree, "cpu")
    pol = dict(fraction=0.125, full_interval=1, block_rows=8)
    ctl_j = JController(jt, JPolicy(strategy=JStrategy.PRIORITY, **pol),
                        fabric=JFabricConfig())
    ctl_t = TController(tt, TPolicy(strategy=TStrategy.PRIORITY, **pol),
                        fabric=TFabricConfig(), device="cpu")
    for step in range(1, 5):
        noise = {k: (1e-2 * rng.normal(size=v.shape)).astype(np.float32)
                 for k, v in tree.items()}
        jt = {k: jt[k] + noise[k] for k in jt}
        tt = {k: tt[k] + torch.from_numpy(noise[k]) for k in tt}
        for ctl, p in ((ctl_j, jt), (ctl_t, tt)):
            ctl.maintain(step, p)
            assert ctl.maybe_checkpoint(step, p)
    fab = ctl_t.fabric
    failed = [int(fab.view.homes[0]), int(fab.replicas.replica_homes[0])]
    failed += [d for d in range(8) if d not in failed][:n_failed - 2]
    failed = np.unique(np.asarray(failed, np.int32))
    lost = np.isin(fab.view.homes, failed)
    _, info_j = ctl_j.on_failure(jt, lost, failed_devices=failed, step=4)
    _, info_t = ctl_t.on_failure(tt, lost, failed_devices=failed, step=4)
    assert info_t["tier_counts"] == info_j["tier_counts"]
    assert info_t["tier_counts"]["PARITY"] > 0
    assert set(info_t["tier_sq"]) == set(info_j["tier_sq"])
    for tier, want in info_j["tier_sq"].items():
        np.testing.assert_allclose(info_t["tier_sq"][tier], float(want),
                                   rtol=1e-4, err_msg=tier)
    assert info_t["tier_sq"]["PARITY"] == 0.0
    assert info_t["tier_sq"]["PEER_REPLICA"] == 0.0
    if n_failed == 3:
        assert info_t["tier_counts"]["RUNNING_CKPT"] > 0
        assert info_t["tier_sq"]["RUNNING_CKPT"] > 0.0


# ---------------------------------------------------------------------------
# masked_restore
# ---------------------------------------------------------------------------

def restore_np_tree(seed: int) -> dict:
    """:func:`np_tree` with an int8 and an f64 leaf."""
    t = np_tree(seed)
    rng = np.random.default_rng(seed + 100)
    t["x"]["i8"] = rng.integers(-128, 128, size=(21, 7), dtype=np.int8)
    t["x"]["f64"] = rng.normal(size=(19, 4))
    return t


def restore_mask(partition, seed: int) -> np.ndarray:
    """A seeded mask over ``partition``'s blocks with one leaf's blocks all
    set and another's all clear."""
    mask = np.random.default_rng(seed).random(partition.total_blocks) < 0.5
    names = [l.name for l in partition.leaves]
    big = partition.leaves[names.index("['x']['big']")]
    even = partition.leaves[names.index("['x']['even']")]
    mask[big.offset:big.offset + big.n_blocks] = True
    mask[even.offset:even.offset + even.n_blocks] = False
    return mask


def emulate_masked_restore(table: lt.RestoreTable, call: lt.RestoreCall,
                           mask: np.ndarray) -> list:
    """The grouped kernel over ``table`` and the call's pointer column:
    each item reads its block's mask bit, then copies its chunk from the
    side the bit picks into the output with its carrier. Returns the
    carriers."""
    col = np.asarray(call.column, np.int64).reshape(-1, 4)
    widths = []
    for g in range(table.n_items):
        l = int(table.item_leaf[g])
        dst, src, out, pitch = (int(v) for v in col[l])
        if out == 0:
            continue
        k, c = divmod(g - int(table.item_start[l]), int(table.cpb[l]))
        block_lo = k * int(table.block_bytes[l])
        length = min(int(table.block_bytes[l]),
                     int(table.total_bytes[l]) - block_lo)
        lo = c * table.chunk
        hi = min(lo + table.chunk, length)
        if lo >= hi:
            continue
        side = (src + k * pitch if mask[int(table.mask_off[l]) + k]
                else dst + block_lo)
        bits = (out + block_lo) | side | length | 16
        w = bits & -bits
        assert lo % w == 0 and hi % w == 0
        widths.append(w)
        _view(out + block_lo + lo, hi - lo, ctypes.c_uint8)[:] = \
            _view(side + lo, hi - lo, ctypes.c_uint8)
    return widths


def _np_bytes(a) -> bytes:
    return np.ascontiguousarray(np.asarray(a)).tobytes()


@pytest.fixture(scope="module")
def restore_case():
    """dst, src and mask over the masked_restore tree, and the reference's
    restore of them (its Pallas kernel in interpret mode, in 64-bit mode
    so the f64 leaf stays f64)."""
    td, ts = restore_np_tree(20), restore_np_tree(21)
    _, tp = partitions(td)
    mask = restore_mask(tp, 22)
    with jax.enable_x64(True):
        jd, js = jax_tree(td), jax_tree(ts)
        jp = jblocks.partition_pytree(jd, BR, colocate=COLOCATE)
        want = [_np_bytes(w) for w in jax.tree_util.tree_leaves(
            j_tree_masked_restore(jd, js, jnp.asarray(mask), jp,
                                  interpret=True))]
    return td, ts, tp, mask, want


@pytest.mark.parametrize("chunk", [lt.COPY_CHUNK_BYTES, 64, 48])
def test_restore_table_covers_every_byte_once(chunk):
    td = restore_np_tree(23)
    _, tp = partitions(td)
    dtypes = tuple(x.dtype for x in tree_leaves(port_tree(td)))
    t = lt.restore_table(tp, dtypes, chunk)
    seen = [np.zeros((n,), np.int64) for n in t.total_bytes.tolist()]
    blocks = [set() for _ in tp.leaves]
    for g in range(t.n_items):
        l = int(t.item_leaf[g])
        k, c = divmod(g - int(t.item_start[l]), int(t.cpb[l]))
        lo = k * int(t.block_bytes[l]) + c * chunk
        seen[l][lo:min(lo + chunk, (k + 1) * int(t.block_bytes[l]),
                       int(t.total_bytes[l]))] += 1
        blocks[l].add(k)
    assert all(np.all(v == 1) for v in seen)
    assert [len(b) for b in blocks] == [l.n_blocks for l in tp.leaves]
    # each leaf reads the mask at its global offset; the output slots are
    # disjoint and 256-byte aligned
    assert t.mask_off.tolist() == [l.offset for l in tp.leaves]
    assert np.all(t.out_off % lt.OUT_ALIGN == 0)
    assert np.all(t.out_off[1:] >= t.out_off[:-1] + t.total_bytes[:-1])
    assert lt.restore_table(tp, dtypes) is lt.restore_table(tp, dtypes)


@pytest.mark.parametrize("chunk", [lt.COPY_CHUNK_BYTES, 64])
def test_masked_restore_walk_matches_reference(restore_case, chunk):
    td, ts, tp, mask, want = restore_case
    dst, src = port_tree(td), port_tree(ts)
    dst_flat, src_flat = tree_leaves(dst), tree_leaves(src)
    table = lt.restore_table(tp, tuple(x.dtype for x in dst_flat), chunk)
    call = lt.restore_call(dst_flat, src_flat, table)
    assert call.keep == []            # every leaf is read in place
    widths = emulate_masked_restore(table, call, mask)
    assert {1, 4, 16} <= set(widths)  # odd views and aligned leaves
    assert [_bytes(g) for g in call.out] == want
    # the outputs: views of one buffer, each leaf at an aligned offset
    base = call.out[0].untyped_storage().data_ptr()
    for o, x in zip(call.out, dst_flat):
        assert o.untyped_storage().data_ptr() == base
        assert (o.data_ptr() - base) % lt.OUT_ALIGN == 0
        assert o.shape == x.shape and o.dtype == x.dtype \
            and o.is_contiguous()
    # the CPU route (the plain version, leaf by leaf) gives the same bytes
    got = mops.tree_masked_restore(dst, src, torch.from_numpy(mask), tp)
    assert [_bytes(g) for g in tree_leaves(got)] == want


def test_colocated_leaves_read_their_shared_bits():
    """One set bit, block 2 of the colocated fc leaves: the three leaves
    that share it take src's rows of that block, and nothing else moves."""
    td, ts = restore_np_tree(24), restore_np_tree(25)
    _, tp = partitions(td)
    names = [l.name for l in tp.leaves]
    fc = [tp.leaves[names.index(f"['{k}']['fc']")] for k in COLOCATE]
    assert len({l.offset for l in fc}) == 1
    mask = np.zeros((tp.total_blocks,), bool)
    mask[fc[0].offset + 2] = True
    dst_flat = tree_leaves(port_tree(td))
    src_flat = tree_leaves(port_tree(ts))
    table = lt.restore_table(tp, tuple(x.dtype for x in dst_flat))
    call = lt.restore_call(dst_flat, src_flat, table)
    emulate_masked_restore(table, call, mask)
    for leaf, d, s, o in zip(tp.leaves, dst_flat, src_flat, call.out):
        want = d.clone()
        if leaf in fc:
            want[2 * BR:3 * BR] = s[2 * BR:3 * BR]
        assert _bytes(o) == _bytes(want), leaf.name


def _arena_trees(seed: int) -> tuple:
    """Word-packable src and dst trees for an arena: multi-block f32 and
    bf16 leaves whose blocks are padded to whole tiles (segment pitch >
    block bytes), an int8 leaf, tail-packed leaves and a scalar. dst's
    ``w`` is bf16 where the arena holds f32 (read through the decoded
    copy), and dst's ``big`` is a view 4 bytes past an aligned address."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    def tree():
        return {"big": f(40, 12), "emb": f(33, 8).astype(ml_dtypes.bfloat16),
                "w": f(50, 6), "i8": rng.integers(-128, 128, size=(20, 3),
                                                  dtype=np.int8),
                "b": f(5), "s": f()}
    src, dst = tree(), tree()
    dst["w"] = dst["w"].astype(ml_dtypes.bfloat16)
    return src, dst


def _port_arena_tree(t: dict, odd: bool = False) -> dict:
    out = {k: port_leaf(v) for k, v in t.items()}
    if odd:
        out["big"] = _odd_view(t["big"], 1)
    return out


def test_arena_restore_walk_matches_reference():
    src, dst = _arena_trees(26)
    jl = jarena.build_arena_layout(jblocks.partition_pytree(
        jax_tree(src), BR))
    tl = tarena.build_arena_layout(tblocks.partition_pytree(
        _port_arena_tree(src), BR))
    part = tl.partition
    mask = np.random.default_rng(27).random(part.total_blocks) < 0.4
    names = [l.name for l in part.leaves]
    s_leaf = part.leaves[names.index("['s']")]
    mask[s_leaf.offset] = False                    # one untouched leaf
    w = names.index("['w']")
    assert mask[part.leaves[w].offset:part.leaves[w].offset
                + part.leaves[w].n_blocks].any()
    want = jarena.arena_restore(jax_tree(dst), jarena.pack_arena(
        jax_tree(src), jl), mask, jl)
    arena = tarena.pack_arena(_port_arena_tree(src), tl)
    dst_t = _port_arena_tree(dst, odd=True)
    leaves = tree_leaves(dst_t)
    touched = tarena.touched_leaves(mask, part)
    assert names.index("['s']") not in touched.tolist()
    srcs = tarena.arena_sources(leaves, arena, touched, tl)
    for li in touched.tolist():
        if li == w:
            assert isinstance(srcs[li], torch.Tensor)    # decoded, bf16
            continue
        addr, pitch = srcs[li]
        assert addr == arena.data_ptr() + 4 * tl.leaf_offset[li]
        assert pitch == 4 * tl.seg_words[li]
    big = names.index("['big']")
    assert srcs[big][1] > 4 * 12 * BR              # pitch past the block
    table = lt.restore_table(part, tuple(x.dtype for x in leaves))
    call = lt.restore_call(leaves, srcs, table, touched)
    emulate_masked_restore(table, call, mask)
    got = [x if r is None else r for x, r in zip(leaves, call.out)]
    for g, wnt in zip(got, jax.tree_util.tree_leaves(want)):
        assert _bytes(g) == _np_bytes(wnt)
    assert got[names.index("['s']")] is leaves[names.index("['s']")]
    # the CPU route (the plain version, leaf by leaf) gives the same bytes
    plain = tree_leaves(tarena.arena_restore(dst_t, arena, mask, tl))
    assert [_bytes(g) for g in plain] == [_bytes(g) for g in got]


def test_restore_refuses_bad_leaves():
    td = restore_np_tree(28)
    _, tp = partitions(td)
    dst = tree_leaves(port_tree(td))
    dtypes = tuple(x.dtype for x in dst)
    table = lt.restore_table(tp, dtypes)
    with pytest.raises(ValueError):                      # leaf count
        lt.restore_call(dst[:-1], dst[:-1], table)
    with pytest.raises(ValueError):                      # a leaf's size
        lt.restore_call(dst, dst[:1] + [dst[0]] + dst[2:], table)
    with pytest.raises(ValueError):                      # a dst's dtype
        lt.restore_call(dst[:1] + [dst[1].double()] + dst[2:], dst, table)

    class Elsewhere(torch.Tensor):
        def get_device(self):
            return 0

    with pytest.raises(ValueError):                      # a leaf's device
        lt.restore_call(dst, dst[:3] + [dst[3].as_subclass(Elsewhere)]
                        + dst[4:], table)
    with pytest.raises(ValueError):
        lt.restore_table(tp, dtypes[:-1])
    with pytest.raises(ValueError, match="CUDA"):
        mkernel.masked_restore_tree_cuda(
            dst, dst, torch.zeros(tp.total_blocks, dtype=torch.bool), tp)


# ---------------------------------------------------------------------------
# ||delta||^2 at recovery: sums of one grouped block_dist pass
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["PARTIAL", "FULL"])
def test_recovery_norms_match_reference(monkeypatch, mode):
    """``full_sq`` and ``partial_sq`` are the sum and the masked sum of one
    pass of per-block distances, ``applied_sq`` the sum of one more; all
    three within rtol 1e-4 of the reference's (plain f32 sums)."""
    tp_, tc = np_tree(29), np_tree(30)
    jp, tp = partitions(tp_)
    mask = np.random.default_rng(31).random(tp.total_blocks) < 0.4
    calls = []
    real = trecovery.tree_block_scores

    def counting(a, b, part):
        calls.append(part)
        return real(a, b, part)

    monkeypatch.setattr(trecovery, "tree_block_scores", counting)
    t_ckpt = TCheckpoint(port_tree(tc), torch.zeros(tp.total_blocks,
                                                    dtype=torch.int32),
                         torch.zeros((), dtype=torch.int32))
    j_ckpt = JCheckpoint(jax_tree(tc), jnp.zeros(jp.total_blocks, jnp.int32),
                         jnp.zeros((), jnp.int32))
    got = trecovery.perturbation_norms(port_tree(tp_), t_ckpt,
                                       torch.from_numpy(mask), tp)
    assert calls == [tp]
    want = jrecovery.perturbation_norms(jax_tree(tp_), j_ckpt,
                                        jnp.asarray(mask), jp)
    for k in ("full_sq", "partial_sq"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4)
    _, got = trecovery.apply_failure_and_recover(
        port_tree(tp_), t_ckpt, torch.from_numpy(mask), TMode[mode], tp)
    assert len(calls) == 3
    _, want = jrecovery.apply_failure_and_recover(
        jax_tree(tp_), j_ckpt, jnp.asarray(mask), JMode[mode], jp)
    for k in ("full_sq", "partial_sq", "applied_sq"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4,
                                   err_msg=k)
