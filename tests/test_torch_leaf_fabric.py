"""The per-leaf fabric path (``FabricConfig(arena=False)``, ``fused=False``
and trees the arena cannot pack), port against reference.

Both packages get the same numpy trees and placement. The port runs the
fused_maintain kernel's plain version on the CPU; the reference runs its
Pallas kernel in interpret mode (f32 leaves) or its jnp path, as named.

- ``leaf_group_metas`` equal (built with a sort here, a loop there);
- ``make_fused_maintain_fn``: replica and parity bit for bit, scores
  within rtol 1e-4 (f32 sums in another order), on f32 leaves with ragged
  and single-block tails, colocated leaves (the CNN's ``net``/``mu``/
  ``nu``), quantized leaves and a bool leaf (which the arena gates and JAX
  holds without x64); its parity equals ``ParityCodec.encode``;
- ``arena=False``, ``fused=False`` and the arena fabric recover the same
  failure to the same values, each equal to the reference's (XOR and RS);
- the quickstart loop with ``FabricConfig(arena=False)`` step by step:
  checkpoint stamps, tier counts, iteration cost and every fabric counter
  equal, losses within rtol 1e-4;
- f64 (port only: the reference downcasts it without x64): the per-leaf
  path against its plain version and the codec's f32-image frames.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core.blocks import partition_pytree as j_partition
from repro.core.controller import FTController as JController
from repro.core.iteration_cost import empirical_iteration_cost as j_cost
from repro.core.policy import CheckpointPolicy as JPolicy
from repro.core.policy import SelectionStrategy as JStrategy
from repro.fabric import CheckpointFabric as JFabric
from repro.fabric import FabricConfig as JConfig
from repro.fabric.domains import FailureDomainMap as JDomains
from repro.fabric.parity import ParityCodec as JCodec
from repro.fabric.placement import ClusterView as JView
from repro.kernels.fused_maintain import ops as jops
from repro.models import classic as jclassic
from repro.sharding.partition import block_device_homes as j_homes
from repro_torch.core.arena import arena_compatible
from repro_torch.core.blocks import partition_pytree as t_partition
from repro_torch.core.controller import FTController as TController
from repro_torch.core.iteration_cost import empirical_iteration_cost as t_cost
from repro_torch.core.policy import CheckpointPolicy as TPolicy
from repro_torch.core.policy import SelectionStrategy as TStrategy
from repro_torch.fabric import CheckpointFabric as TFabric
from repro_torch.fabric import FabricConfig as TConfig
from repro_torch.fabric.domains import FailureDomainMap as TDomains
from repro_torch.fabric.parity import ParityCodec as TCodec
from repro_torch.fabric.placement import ClusterView as TView
from repro_torch.interop import from_numpy_tree, to_numpy_tree
from repro_torch.kernels.fused_maintain import ops as tops
from repro_torch.kernels.fused_maintain.ref import fused_maintain_ref
from repro_torch.models import classic as tclassic
from repro_torch.sharding.partition import block_device_homes as t_homes
from repro_torch.utils.tree import tree_leaves, tree_map



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while these tests run: the suite runs several
    workers on a few cores, and spinning torch threads would starve the
    multi-device JAX programs that other workers run meanwhile."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _leaf(rng, shape, dtype):
    if np.dtype(dtype) == np.bool_:
        return rng.random(shape) < 0.5
    if np.dtype(dtype).kind in "iu":
        return rng.integers(-100, 100, shape).astype(dtype)
    return rng.normal(size=shape).astype(np.float32).astype(dtype)


def _tree(kind, seed=0):
    """f32: ragged, single-block and scalar leaves; colocate: the CNN's
    net/mu/nu; quant: bf16, fp8, int8, f16 with f32; bool: a bool leaf."""
    rng = np.random.default_rng(seed)
    if kind == "f32":
        return {"big": _leaf(rng, (40, 300), np.float32),
                "w": _leaf(rng, (50, 6), np.float32),
                "b": _leaf(rng, (5,), np.float32),
                "s": _leaf(rng, (), np.float32)}
    if kind == "quant":
        return {"big": _leaf(rng, (40, 300), ml_dtypes.bfloat16),
                "e": _leaf(rng, (64, 33), ml_dtypes.float8_e4m3fn),
                "i": _leaf(rng, (48, 20), np.int8),
                "h": _leaf(rng, (9,), np.float16),
                "w": _leaf(rng, (30, 7), np.float32)}
    if kind == "bool":
        return {"m": _leaf(rng, (61, 5), np.bool_),
                "w": _leaf(rng, (96, 9), np.float32),
                "b": _leaf(rng, (6,), np.float32)}
    net = {"conv": _leaf(rng, (24, 3, 3), np.float32),
           "fc": _leaf(rng, (40, 10), np.float32),
           "b": _leaf(rng, (10,), np.float32)}
    return {"net": net, "mu": {k: v * 0.5 for k, v in net.items()},
            "nu": {k: v * v for k, v in net.items()}}


def _col(kind):
    return ("net", "mu", "nu") if kind == "colocate" else ()


def _to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _codecs(kind, block_rows=8, seed=0):
    np_tree = _tree(kind, seed)
    jt, tt = _to_jax(np_tree), from_numpy_tree(np_tree, "cpu")
    jp = j_partition(jt, block_rows, colocate=_col(kind))
    tp = t_partition(tt, block_rows, colocate=_col(kind))
    jc = JCodec(jp, JView(JDomains(8, 2, 2), j_homes(jp, 8)), group_size=3,
                use_pallas=False)
    tc = TCodec(tp, TView(TDomains(8, 2, 2), t_homes(tp, 8)), group_size=3)
    return np_tree, jt, tt, jp, tp, jc, tc


def _bits(x):
    a = np.asarray(x)
    return a.view(np.uint8) if a.dtype.itemsize == 1 else a


KINDS = ["f32", "colocate", "quant", "bool"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("block_rows", [4, 8, 16])
def test_leaf_group_metas_equal(kind, block_rows):
    *_, jp, tp, jc, tc = _codecs(kind, block_rows)
    np.testing.assert_array_equal(tc.group_of, np.asarray(jc.group_of))
    for a, b in zip(tops.leaf_group_metas(tp, tc.layout, tc.group_of),
                    jops.leaf_group_metas(jp, jc.layout, jc.group_of)):
        for f in ("perm", "outrow", "first", "touched", "members"):
            np.testing.assert_array_equal(getattr(a, f),
                                          np.asarray(getattr(b, f)), f)
        assert (a.col, a.width) == (b.col, b.width)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("path", ["pallas", "jnp"])
def test_fused_maintain_fn_matches_reference(kind, path):
    """Replica and parity bit for bit, scores within rtol 1e-4; the parity
    also equals both packages' ``ParityCodec.encode``. ``pallas``: the
    reference's Pallas kernel in interpret mode on its f32 leaves (its jnp
    path on the rest, as it routes them)."""
    np_tree, jt, tt, jp, tp, jc, tc = _codecs(kind)
    z_np = _tree(kind, seed=1)
    jz, tz = _to_jax(z_np), from_numpy_tree(z_np, "cpu")
    jfn = jops.make_fused_maintain_fn(jp, jc.layout, jc.group_of,
                                      jc.n_groups,
                                      use_pallas=path == "pallas",
                                      interpret=True)
    tfn = tops.make_fused_maintain_fn(tp, tc.layout, tc.group_of,
                                      tc.n_groups)
    rj, sj, pj = jfn(jt, jz)
    rt, st, pt = tfn(tt, tz)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    for a, b in zip(tree_leaves(to_numpy_tree(rt)),
                    jax.tree_util.tree_leaves(rj)):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-4,
                               atol=1e-6)
    jc.encode(1, jt)
    tc.encode(1, tt)
    np.testing.assert_array_equal(tc.parity.numpy(), pt.numpy())
    np.testing.assert_array_equal(np.asarray(jc.parity), pt.numpy())
    # without parity (the RS fabric's sweep) the replica and scores stay
    rt2, st2, none = tops.make_fused_maintain_fn(
        tp, tc.layout, tc.group_of, tc.n_groups, parity=False)(tt, tz)
    assert none is None and torch.equal(st2, st)


MODES = [dict(arena=False), dict(fused=False), dict()]


@pytest.mark.parametrize("kind", ["f32", "colocate", "bool"])
@pytest.mark.parametrize("rs", [0, 2])
def test_fabric_modes_recover_alike(kind, rs):
    """The loss of block 0's primary and replica homes after two maintains
    with scores: each mode's tier counts, recovered values and parity
    equal the reference's in the same mode, and the three modes agree
    (the arena mode only where the tree is word-packable)."""
    np_tree = _tree(kind)
    drift = _tree(kind, seed=3)
    results = []
    for mode in MODES:
        if mode == {} and kind == "bool":
            continue
        jt, tt = _to_jax(np_tree), from_numpy_tree(np_tree, "cpu")
        jp = j_partition(jt, 8, colocate=_col(kind))
        tp = t_partition(tt, 8, colocate=_col(kind))
        jf = JFabric(jp, JConfig(use_pallas=False, rs_parity=rs, **mode))
        tf = TFabric(tp, TConfig(rs_parity=rs, **mode))
        assert (tf.arena_layout is None) == (jf.arena_layout is None)
        assert (tf.arena_layout is None) == (
            mode != {} or not arena_compatible(tp))
        for step, z in ((1, None), (2, drift)):
            tf.maintain(step, tt, None if z is None
                        else from_numpy_tree(z, "cpu"))
            jf.maintain(step, jt, None if z is None else _to_jax(z))
        np.testing.assert_array_equal(tf.parity.parity.numpy(),
                                      np.asarray(jf.parity.parity))
        if jf.last_scores is not None:
            np.testing.assert_allclose(tf.last_scores.numpy(),
                                       np.asarray(jf.last_scores),
                                       rtol=1e-4, atol=1e-6)
        for k in ("replica_refreshes", "parity_encodes", "fused_maintains",
                  "arena_maintains", "rs_arena_encodes",
                  "maintain_bytes_moved"):
            assert tf.stats[k] == jf.stats[k], (mode, k)
        homes = tf.view.homes
        failed = np.unique([homes[0], tf.replicas.replica_homes[0]])
        lost = np.isin(homes, failed)
        ck_np = _tree(kind, seed=4)
        rj, sj = jf.on_failure(jt, _to_jax(ck_np), lost,
                               failed_devices=failed, step=2)
        rt, st = tf.on_failure(tt, from_numpy_tree(ck_np, "cpu"), lost,
                               failed_devices=failed, step=2)
        assert st["tier_counts"] == sj["tier_counts"], mode
        assert st["tier_counts"]["PARITY"] > 0
        for a, b in zip(tree_leaves(to_numpy_tree(rt)),
                        jax.tree_util.tree_leaves(rj)):
            np.testing.assert_array_equal(_bits(a), _bits(b))
        results.append((st["tier_counts"], to_numpy_tree(rt),
                        tf.parity.parity.numpy()))
    for counts, rec, par in results[1:]:
        assert counts == results[0][0]
        np.testing.assert_array_equal(par, results[0][2])
        for a, b in zip(tree_leaves(rec), tree_leaves(results[0][1])):
            np.testing.assert_array_equal(_bits(a), _bits(b))


KW = dict(n=600, dim=64, n_classes=5, batch=200)   # examples/quickstart.py
MAX_ITERS, FAIL_ITER = 60, 25


@pytest.mark.parametrize("cfg", [dict(arena=False),
                                 dict(arena=False, rs_parity=2)])
def test_quickstart_loop_per_leaf_matches_reference(cfg):
    """``examples/quickstart.py``'s loop with a per-leaf fabric, step by
    step in both packages on the reference's init and batch draws, the
    failure a whole host drawn from the same numpy seed."""
    ref = jclassic.make_model("mlr", **KW)
    port = dataclasses.replace(tclassic.make_model("mlr", device="cpu", **KW),
                               eps=ref.eps)
    jpol = dataclasses.replace(JPolicy.scar(0.25, 32), block_rows=8,
                               strategy=JStrategy.PRIORITY)
    tpol = dataclasses.replace(TPolicy.scar(0.25, 32), block_rows=8,
                               strategy=TStrategy.PRIORITY)
    p_ref = ref.init(jax.random.PRNGKey(1))
    p_port = from_numpy_tree(jax.tree_util.tree_map(np.asarray, p_ref),
                             "cpu")
    ctl_ref = JController(p_ref, jpol, norm_aux=ref.norm_aux,
                          rng=jax.random.PRNGKey(13),
                          fabric=JConfig(use_pallas=False, **cfg))
    ctl_port = TController(p_port, tpol, norm_aux=port.norm_aux,
                           rng=torch.Generator().manual_seed(13),
                           fabric=TConfig(**cfg), device="cpu")
    assert not ctl_port.arena_ready and not ctl_ref.arena_ready
    losses_ref, losses_port, draws = [], [], {}
    for i in range(1, MAX_ITERS + 1):
        key = jax.random.fold_in(jax.random.PRNGKey(0), i)
        draws[i] = torch.from_numpy(np.asarray(jax.random.choice(
            key, KW["n"], (KW["batch"],), replace=False)).astype(np.int64))
        p_ref = ref.step(p_ref, key, i)
        p_port = port.update(p_port, draws[i], i)
        for ctl, p in ((ctl_ref, p_ref), (ctl_port, p_port)):
            ctl.maintain(i, p)
            ctl.maybe_checkpoint(i, p)
        np.testing.assert_array_equal(ctl_port.ckpt.saved_iter.numpy(),
                                      np.asarray(ctl_ref.ckpt.saved_iter))
        if i == FAIL_ITER:
            lost, failed = ctl_ref.sample_domain_failure("host")
            t_lost, t_failed = ctl_port.sample_domain_failure("host")
            np.testing.assert_array_equal(t_lost, lost)
            p_ref, info_ref = ctl_ref.on_failure(p_ref, lost, step=i,
                                                 failed_devices=failed)
            p_port, info_port = ctl_port.on_failure(
                p_port, torch.from_numpy(np.array(lost)), step=i,
                failed_devices=t_failed)
            assert info_port["tier_counts"] == info_ref["tier_counts"]
            np.testing.assert_allclose(info_port["applied_sq"],
                                       info_ref["applied_sq"], rtol=1e-4,
                                       atol=1e-12)
        losses_ref.append(float(ref.loss(p_ref)))
        losses_port.append(float(port.loss(p_port)))
    fs_ref, fs_port = ctl_ref.fabric.stats, ctl_port.fabric.stats
    assert set(fs_port) == set(fs_ref)
    for k in fs_ref:
        assert fs_port[k] == fs_ref[k], k
    assert fs_port["fused_maintains"] == MAX_ITERS
    np.testing.assert_allclose(losses_port, losses_ref, rtol=1e-4)
    clean_ref, clean_port = [], []
    pr = ref.init(jax.random.PRNGKey(1))
    pp = from_numpy_tree(jax.tree_util.tree_map(np.asarray, pr), "cpu")
    for i in range(1, MAX_ITERS + 1):
        pr = ref.step(pr, jax.random.fold_in(jax.random.PRNGKey(0), i), i)
        pp = port.update(pp, draws[i], i)
        clean_ref.append(float(ref.loss(pr)))
        clean_port.append(float(port.loss(pp)))
    assert t_cost(losses_port, clean_port, port.eps) == \
        j_cost(losses_ref, clean_ref, ref.eps)


def test_f64_per_leaf_path_against_plain_version():
    """f64 leaves (port only): the per-leaf fabric holds them, its sweep
    equals the plain version leaf by leaf and its parity the codec's
    encode of the f32 images; a host loss restores PEER_REPLICA blocks
    bit for bit and PARITY blocks as the f32 image of the live value."""
    gen = torch.Generator().manual_seed(0)
    tree = {"d": torch.randn(40, 6, generator=gen, dtype=torch.float64),
            "w": torch.randn(30, 5, generator=gen),
            "i": torch.randint(-9, 9, (17,), generator=gen)}
    part = t_partition(tree, 8)
    fab = TFabric(part, TConfig())
    assert fab.arena_layout is None and not arena_compatible(part)
    z = tree_map(lambda v: v * 2, tree)
    fab.maintain(1, tree, z)
    codec = fab.parity
    fe = codec.layout.frame_elems
    par = torch.zeros((codec.n_groups * fe,), dtype=torch.int32)
    metas = tops.leaf_group_metas(part, codec.layout, codec.group_of)
    for x, zz, leaf, meta in zip(tree_leaves(tree), tree_leaves(z),
                                 part.leaves, metas):
        t = tops.leaf_tables(meta, leaf.n_blocks, torch.device("cpu"))
        rep, sc = fused_maintain_ref(x, zz, par, t, 8, meta.col, fe)
        torch.testing.assert_close(
            fab.last_scores[leaf.offset:leaf.offset + leaf.n_blocks], sc,
            rtol=1e-6, atol=0)
    assert torch.equal(par.view(codec.n_groups, fe), codec.parity)
    ref_codec = TCodec(part, fab.view, arena_layout=codec.arena_layout)
    ref_codec.encode(1, tree)
    assert torch.equal(ref_codec.parity, codec.parity)
    failed = np.unique([fab.view.homes[0], fab.replicas.replica_homes[0]])
    lost = np.isin(fab.view.homes, failed)
    rec, info = fab.on_failure(tree, z, lost, failed_devices=failed, step=1)
    assert info["tier_counts"]["PARITY"] > 0
    plan = fab.planner.plan(lost, failed, 1)
    for x, r, leaf in zip(tree_leaves(tree), tree_leaves(rec), part.leaves):
        rows = np.repeat(np.arange(leaf.offset, leaf.offset + leaf.n_blocks),
                         8)[:max(leaf.rows, 1)]
        tiers = plan.tiers[rows]
        x2, r2 = x.reshape(max(leaf.rows, 1), -1), r.reshape(
            max(leaf.rows, 1), -1)
        assert torch.equal(r2[tiers == 1], x2[tiers == 1])       # replica
        assert torch.equal(r2[tiers == 2],
                           x2[tiers == 2].to(torch.float32).to(x.dtype))
