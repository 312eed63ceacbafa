"""The RS(k, m) erasure tier and its integrity scrub, port against
reference.

Both packages get the same numpy inputs and the same placement. On the
CPU the port runs the gf256_mac kernel's plain version; the reference runs
its jnp oracle and, where a test names it, its Pallas kernel in interpret
mode. Everything the reference computes bit-exactly is held bit for bit:

- the GF(256) tables, ``gf_mul``/``gf_inv``/``gf_mat_inv``,
  ``rs_coefficients``, ``rs_decode_weights`` and ``gf_scale_words_np``;
- ``gf256_mac`` (dense and plan forms), ``rs_encode`` and ``rs_decode``
  against ``gf256_mac_ref``, ``gf256_mac_np`` and ``gf256_mac_pallas``;
- ``RSCodec``'s rows (from a tree and from the arena), homes and members,
  RS(k, 1) row 0 against the XOR parity;
- the two-host simultaneous loss (values and tier counts), the XOR
  fallback baseline, the controller's two-event path;
- the scrub: a member flip detected, localized and corrected, a corrupted
  stored row, m = 1 detecting without localizing, the controller's scrub,
  and the port's syndromes and reports on the reference's own coded
  snapshot;
- ``advise`` and ``advise_code`` (floats within 1e-12 relative: the same
  host arithmetic);
- ``examples/correlated_failures.py``'s multi-erasure section through
  ``run_with_trace`` (both fed the reference's batch draws): equal tier
  counts, fallbacks and iteration cost.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import advisor as jadv
from repro.core.blocks import partition_pytree as j_partition
from repro.core.controller import FTController as JController
from repro.core.policy import CheckpointPolicy as JPolicy
from repro.core.policy import RecoveryMode as JRecovery
from repro.core.policy import SelectionStrategy as JStrategy
from repro.fabric import CheckpointFabric as JFabric
from repro.fabric import FabricConfig as JConfig
from repro.fabric import FailureEvent as JEvent
from repro.kernels.gf256_mac import ops as jops
from repro.kernels.gf256_mac import tables as jtab
from repro.kernels.gf256_mac.kernel import gf256_mac_pallas
from repro.kernels.gf256_mac.ref import gf256_mac_ref as j_mac_ref
from repro.models import classic as jclassic
from repro.training import classic_runner as jrunner
from repro_torch.core import advisor as tadv
from repro_torch.core.blocks import partition_pytree as t_partition
from repro_torch.core.controller import FTController as TController
from repro_torch.core.policy import CheckpointPolicy as TPolicy
from repro_torch.core.policy import RecoveryMode as TRecovery
from repro_torch.core.policy import SelectionStrategy as TStrategy
from repro_torch.fabric import CheckpointFabric as TFabric
from repro_torch.fabric import FabricConfig as TConfig
from repro_torch.fabric import FailureEvent as TEvent
from repro_torch.fabric import rs as rs_mod
from repro_torch.fabric.rs import Syndromes
from repro_torch.interop import load_parity_rows, parity_rows_to_numpy
from repro_torch.kernels.gf256_mac import ops as tops
from repro_torch.kernels.gf256_mac import tables as ttab
from repro_torch.kernels.gf256_mac.ref import gf256_mac_np
from repro_torch.models import classic as tclassic
from repro_torch.training import classic_runner as trunner

TOPO = dict(n_devices=8, devices_per_host=2, hosts_per_rack=2)



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while these tests run: the suite runs several
    workers on a few cores, and spinning torch threads would starve the
    multi-device JAX programs that other workers run meanwhile."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _np_params(seed=11, rows=256, width=6):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(rows, width)).astype(np.float32),
            "b": rng.normal(size=(8,)).astype(np.float32)}


def _pair(np_tree):
    return ({k: jnp.asarray(v) for k, v in np_tree.items()},
            {k: torch.from_numpy(v.copy()) for k, v in np_tree.items()})


def _fabrics(np_tree, block_rows=16, **kw):
    jt, tt = _pair(np_tree)
    jf = JFabric(j_partition(jt, block_rows), JConfig(use_pallas=False,
                                                      **TOPO, **kw))
    tf = TFabric(t_partition(tt, block_rows), TConfig(**TOPO, **kw))
    return jt, tt, jf, tf


def _equal_trees(t_tree, j_tree):
    for k in j_tree:
        np.testing.assert_array_equal(t_tree[k].numpy(), np.asarray(j_tree[k]))


# ---------------------------------------------------------------------------
# GF(256) tables
# ---------------------------------------------------------------------------

def test_gf_tables_and_field_ops_equal():
    np.testing.assert_array_equal(ttab.GF_EXP, jtab.GF_EXP)
    np.testing.assert_array_equal(ttab.GF_LOG, jtab.GF_LOG)
    a, b = np.meshgrid(np.arange(256), np.arange(256))
    np.testing.assert_array_equal(ttab.gf_mul(a, b), jtab.gf_mul(a, b))
    nz = np.arange(1, 256)
    np.testing.assert_array_equal(ttab.gf_inv(nz), jtab.gf_inv(nz))
    rng = np.random.default_rng(0)
    words = rng.integers(-2**31, 2**31, 97).astype(np.int32)
    for c in (0, 1, 2, 29, 255):
        np.testing.assert_array_equal(ttab.gf_scale_words_np(words, c),
                                      jtab.gf_scale_words_np(words, c))


@pytest.mark.parametrize("width,m", [(2, 1), (4, 2), (6, 3), (3, 2)])
def test_rs_coefficients_and_decode_weights_equal(width, m):
    coeff = ttab.rs_coefficients(width, m)
    np.testing.assert_array_equal(coeff, jtab.rs_coefficients(width, m))
    np.testing.assert_array_equal(coeff[0], 1)
    rng = np.random.default_rng(width * 10 + m)
    for _ in range(20):
        e = int(rng.integers(1, m + 1))
        erased = np.sort(rng.choice(width, e, replace=False))
        survivors = np.setdiff1d(np.arange(width), erased)
        rows = rng.permutation(m)
        np.testing.assert_array_equal(
            ttab.gf_mat_inv(coeff[np.ix_(rows[:e], erased)]),
            jtab.gf_mat_inv(coeff[np.ix_(rows[:e], erased)]))
        np.testing.assert_array_equal(
            ttab.rs_decode_weights(coeff, erased, survivors, rows),
            jtab.rs_decode_weights(coeff, erased, survivors, rows))


# ---------------------------------------------------------------------------
# gf256_mac
# ---------------------------------------------------------------------------

MAC_SHAPES = [(5, 4, 70), (3, 1, 513), (1, 6, 1), (4, 3, 1024)]


@pytest.mark.parametrize("n,g,e", MAC_SHAPES)
def test_gf256_mac_matches_reference_and_pallas(n, g, e):
    """Bit-exact against the jnp oracle, the numpy mirror and the Pallas
    kernel in interpret mode; coefficients 0 and 1 included."""
    rng = np.random.default_rng(n * 100 + e)
    frames = rng.integers(-2**31, 2**31, (n, g, e)).astype(np.int32)
    base = rng.integers(-2**31, 2**31, (n, e)).astype(np.int32)
    coeff = rng.integers(0, 256, (n, g)).astype(np.int32)
    coeff[0, 0], coeff[-1, -1] = 0, 1
    want = np.asarray(j_mac_ref(jnp.asarray(frames), jnp.asarray(base),
                                jnp.asarray(coeff)))
    got = tops.gf256_mac(torch.from_numpy(frames), torch.from_numpy(base),
                         torch.from_numpy(coeff)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(gf256_mac_np(frames, base, coeff), want)
    pal = np.asarray(gf256_mac_pallas(jnp.asarray(frames), jnp.asarray(base),
                                      jnp.asarray(coeff), interpret=True))
    np.testing.assert_array_equal(got, pal)
    # the plan form: one row per group, a term per member, on flat words
    plan = tops._dense_plan(n, g, e, coeff[:, :, None].astype(np.int64),
                            based=True)
    out = torch.empty((n * e,), dtype=torch.int32)
    tops.gf256_mac_plan(out, torch.from_numpy(frames).reshape(-1), None,
                        torch.from_numpy(base).reshape(-1), plan)
    np.testing.assert_array_equal(out.view(n, e).numpy(), want)


@pytest.mark.parametrize("width,m", [(5, 2), (4, 3), (3, 1)])
def test_rs_encode_decode_match_reference(width, m):
    rng = np.random.default_rng(width + 7 * m)
    n, e = 4, 48
    coeff = ttab.rs_coefficients(width, m)
    frames = rng.integers(-2**31, 2**31, (n, width, e)).astype(np.int32)
    valid = np.ones((n, width), bool)
    valid[-1, -1] = False
    frames[-1, -1] = 0
    rows = np.where(valid[None], coeff[:, None, :], 0).astype(np.int32)
    want = np.asarray(jops.rs_encode(jnp.asarray(frames), jnp.asarray(rows),
                                     use_pallas=False))
    parity = tops.rs_encode(torch.from_numpy(frames), rows)
    np.testing.assert_array_equal(parity.numpy(), want)
    ext = np.concatenate([frames, want], axis=1)
    w = np.zeros((n, width + m), np.int32)
    for j in range(n):
        slots = np.nonzero(valid[j])[0]
        erased = np.sort(rng.choice(slots, min(m, slots.size), replace=False))
        survivors = np.setdiff1d(slots, erased)
        w[j] = ttab.rs_decode_weights(coeff, erased, survivors,
                                      np.arange(m))[0]
    got = tops.rs_decode(torch.from_numpy(ext), w).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jops.rs_decode(jnp.asarray(ext), jnp.asarray(w),
                                       use_pallas=False)))


# ---------------------------------------------------------------------------
# the codec
# ---------------------------------------------------------------------------

def _trees(kind):
    rng = np.random.default_rng(5)
    if kind == "colocate":
        net = {"a": rng.normal(size=(40, 40)).astype(np.float32),
               "b": rng.normal(size=(7,)).astype(np.float32)}
        return {"net": net, "mu": {k: v * 0.5 for k, v in net.items()}}, \
            ("net", "mu")
    if kind == "tail":
        return {"big": rng.normal(size=(40, 300)).astype(np.float32),
                "w": rng.normal(size=(50, 6)).astype(np.float32),
                "b": rng.normal(size=(5,)).astype(np.float32)}, ()
    return _np_params(), ()


@pytest.mark.parametrize("kind", ["f32", "tail", "colocate"])
@pytest.mark.parametrize("m", [1, 2, 3])
def test_rs_codec_rows_match_reference(kind, m):
    """Rows bit-equal to the reference's RSCodec from the arena (the
    fabric's sweep) and from a tree, on the same striping and homes."""
    np_tree, col = _trees(kind)
    jt = jax.tree_util.tree_map(jnp.asarray, np_tree)
    tt = jax.tree_util.tree_map(lambda v: torch.from_numpy(v.copy()),
                                np_tree)
    topo = dict(n_devices=8, devices_per_host=1, hosts_per_rack=4)
    jf = JFabric(j_partition(jt, 8, colocate=col),
                 JConfig(use_pallas=False, rs_parity=m, **topo))
    tf = TFabric(t_partition(tt, 8, colocate=col),
                 TConfig(rs_parity=m, **topo))
    np.testing.assert_array_equal(tf.parity.members,
                                  np.asarray(jf.parity.members))
    np.testing.assert_array_equal(tf.parity.parity_homes,
                                  np.asarray(jf.parity.parity_homes))
    np.testing.assert_array_equal(tf.parity.coeff, jf.parity.coeff)
    jf.maintain(2, jt)
    tf.maintain(2, tt)
    assert tf.stats["rs_arena_encodes"] == jf.stats["rs_arena_encodes"] == 1
    np.testing.assert_array_equal(parity_rows_to_numpy(tf.parity),
                                  np.asarray(jf.parity.parity))
    jf.parity.encode(3, jt)
    tf.parity.encode(3, tt)
    np.testing.assert_array_equal(tf.parity.parity.numpy(),
                                  np.asarray(jf.parity.parity))
    assert tf.redundancy_nbytes() == jf.redundancy_nbytes()
    assert tf.redundancy_state() == jf.redundancy_state()


def test_rs1_row0_matches_xor_parity():
    np_tree = _np_params()
    _, tt = _pair(np_tree)
    part = t_partition(tt, 16)
    xor = TFabric(part, TConfig(replicate=False, **TOPO))
    rs1 = TFabric(part, TConfig(replicate=False, rs_parity=1, **TOPO))
    xor.maintain(2, tt)
    rs1.maintain(2, tt)
    np.testing.assert_array_equal(xor.parity.members, rs1.parity.members)
    assert torch.equal(xor.parity.parity, rs1.parity.parity[:, 0])


# ---------------------------------------------------------------------------
# multi-erasure recovery
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tiers", [dict(replicate=False), dict()])
def test_two_host_simultaneous_loss_matches_reference(tiers):
    """Every host pair lost in one step: the same tier counts as the
    reference, and the recovered values bit for bit (RS(k, 2) decodes both
    erasures: PARITY only, zero perturbation, no fallback)."""
    jt, tt, jf, tf = _fabrics(_np_params(), rs_parity=2, **tiers)
    ck = {k: v * 0 for k, v in tt.items()}
    jck = {k: v * 0 for k, v in jt.items()}
    jf.maintain(3, jt)
    tf.maintain(3, tt)
    for h0 in range(4):
        for h1 in range(h0 + 1, 4):
            l0, f0 = tf.domain_failure("host", h0)
            l1, f1 = tf.domain_failure("host", h1)
            lost = l0 | l1
            failed = np.unique(np.concatenate([f0, f1]))
            rj, sj = jf.on_failure(jt, jck, lost, failed_devices=failed,
                                   step=3, persist_failure=False)
            rt, st = tf.on_failure(tt, ck, lost, failed_devices=failed,
                                   step=3, persist_failure=False)
            assert st["tier_counts"] == sj["tier_counts"]
            assert st["tier_counts"]["RUNNING_CKPT"] == 0
            assert st["tier_sq"]["PARITY"] == 0.0
            assert st["tier_fallbacks"] == [] == sj["tier_fallbacks"]
            _equal_trees(rt, rj)
            _equal_trees(rt, jt)


def test_xor_two_host_fallback_matches_reference():
    """The XOR tier's baseline for the same double loss: strength-1 groups
    with two erasures fall back to the checkpoint tiers, each announced."""
    jt, tt, jf, tf = _fabrics(_np_params(), replicate=False)
    jf.maintain(3, jt)
    tf.maintain(3, tt)
    l0, f0 = tf.domain_failure("host", 0)
    l1, f1 = tf.domain_failure("host", 1)
    lost, failed = l0 | l1, np.unique(np.concatenate([f0, f1]))
    rj, sj = jf.on_failure(jt, {k: v * 0 for k, v in jt.items()}, lost,
                           failed_devices=failed, step=3,
                           persist_failure=False)
    rt, st = tf.on_failure(tt, {k: v * 0 for k, v in tt.items()}, lost,
                           failed_devices=failed, step=3,
                           persist_failure=False)
    assert st["tier_counts"] == sj["tier_counts"]
    assert st["tier_counts"]["PARITY"] == 0
    assert st["tier_fallbacks"] == sj["tier_fallbacks"]
    assert len(st["tier_fallbacks"]) > 0
    assert tf.stats["tier_fallbacks"] == jf.stats["tier_fallbacks"]
    _equal_trees(rt, rj)


def _rr_policy(pkg):
    P, S, R = ((JPolicy, JStrategy, JRecovery) if pkg == "j"
               else (TPolicy, TStrategy, TRecovery))
    return P(fraction=0.5, full_interval=4, strategy=S.ROUND_ROBIN,
             recovery=R.PARTIAL)


def test_controller_two_domain_events_match_reference():
    jt, tt = _pair(_np_params())
    cfg = dict(rs_parity=2, replicate=False, **TOPO)
    jc = JController(jt, _rr_policy("j"),
                     fabric=JConfig(use_pallas=False, **cfg))
    tc = TController(tt, _rr_policy("t"), fabric=TConfig(**cfg),
                     device="cpu")
    for c, p in ((jc, jt), (tc, tt)):
        c.fabric.maintain(3, p)
        c.checkpoint_now(3, p)
    rj, ij = jc.on_domain_events(jt, [("host", 0), ("host", 1)], step=3)
    rt, it = tc.on_domain_events(tt, [("host", 0), ("host", 1)], step=3)
    assert it["applied_sq"] == 0.0 == ij["applied_sq"]
    assert it["tier_counts"] == ij["tier_counts"]
    assert it["events"] == ij["events"]
    _equal_trees(rt, rj)


# ---------------------------------------------------------------------------
# the integrity scrub
# ---------------------------------------------------------------------------

def _strip(report):
    return {k: v for k, v in report.items() if k != "delta"}


def test_scrub_detects_localizes_corrects_member_flip():
    jt, tt, jf, tf = _fabrics(_np_params(), rs_parity=2)
    jf.maintain(4, jt)
    tf.maintain(4, tt)
    wj = jf.inject_arena_bit_flip(block=7, word=3, bit=19)
    wt = tf.inject_arena_bit_flip(block=7, word=3, bit=19)
    assert wt == wj
    oj, ot = jf.scrub(step=4), tf.scrub(step=4)
    assert ot == oj
    assert ot["detected"] == 1 and ot["corrected"] == 1
    assert ot["reports"][0]["kind"] == "member"
    assert ot["reports"][0]["block"] == wt["block"]
    # corrected in place: bit-equal to the reference's replica, a second
    # pass is clean, and a host loss recovers the snapshot bit-exactly
    np.testing.assert_array_equal(
        tf.replicas.arena.numpy(),
        np.asarray(jf.replicas.arena).view(np.int32))
    assert tf.scrub(step=4)["detected"] == 0
    l0, f0 = tf.domain_failure("host", 0)
    rt, _ = tf.on_failure(tt, {k: v * 0 for k, v in tt.items()}, l0,
                          failed_devices=f0, step=4, persist_failure=False)
    _equal_trees(rt, jt)
    assert tf.stats["scrubs"] == jf.stats["scrubs"] + 1   # the clean pass
    for k in ("silent_errors_detected", "silent_errors_corrected"):
        assert tf.stats[k] == jf.stats[k] == 1
    # the rng draws follow the reference's order
    assert tf.inject_arena_bit_flip(rng=np.random.default_rng(3)) == \
        jf.inject_arena_bit_flip(rng=np.random.default_rng(3))


def test_scrub_detects_corrupted_parity_row():
    jt, tt, jf, tf = _fabrics(_np_params(), rs_parity=2)
    jf.maintain(4, jt)
    tf.maintain(4, tt)
    cur = int(np.asarray(jf.parity.parity[2, 1, 5]))
    jf.parity.parity = jf.parity.parity.at[2, 1, 5].set(
        jnp.int32(cur ^ (1 << 9)))
    tf.parity.parity[2, 1, 5] ^= 1 << 9
    oj, ot = jf.scrub(step=4), tf.scrub(step=4)
    assert ot == oj
    assert ot["reports"][0]["kind"] == "parity"
    assert ot["reports"][0]["row"] == 1 and ot["reports"][0]["group"] == 2
    np.testing.assert_array_equal(tf.parity.parity.numpy(),
                                  np.asarray(jf.parity.parity))
    assert tf.scrub(step=4)["detected"] == 0


def test_scrub_m1_detects_without_localizing():
    jt, tt, jf, tf = _fabrics(_np_params(), rs_parity=1)
    jf.maintain(4, jt)
    tf.maintain(4, tt)
    jf.inject_arena_bit_flip(block=3, word=1, bit=4)
    tf.inject_arena_bit_flip(block=3, word=1, bit=4)
    oj, ot = jf.scrub(step=4), tf.scrub(step=4)
    assert ot == oj
    assert ot["checked"] and ot["detected"] == 1 and ot["corrected"] == 0
    assert not ot["reports"][0]["localized"]


def test_controller_scrub_matches_reference():
    jt, tt = _pair(_np_params())
    cfg = dict(rs_parity=2, **TOPO)
    jc = JController(jt, _rr_policy("j"),
                     fabric=JConfig(use_pallas=False, **cfg))
    tc = TController(tt, _rr_policy("t"), fabric=TConfig(**cfg),
                     device="cpu")
    for c, p in ((jc, jt), (tc, tt)):
        c.fabric.maintain(4, p)
        c.fabric.inject_arena_bit_flip(block=1)
    oj, ot = jc.scrub(step=4), tc.scrub(step=4)
    assert ot == oj and ot["detected"] == 1 and ot["corrected"] == 1
    xor = TController(tt, _rr_policy("t"), fabric=TConfig(**TOPO),
                      device="cpu")
    assert xor.scrub(step=4) == {"checked": False, "detected": 0,
                                 "corrected": 0, "reports": []}


@pytest.mark.parametrize("flip", ["member", "two_members", "row"])
def test_scrub_on_the_reference_coded_snapshot(flip, monkeypatch):
    """The reference's stored rows carried into the port's codec: both
    packages scrub one coded snapshot, with one corruption applied to both,
    and agree on the syndromes (one group per syndrome batch) and the
    reports."""
    monkeypatch.setattr(rs_mod, "SYNDROME_BATCH_BYTES", 1)
    jt, tt, jf, tf = _fabrics(_np_params(seed=2), rs_parity=2)
    jf.maintain(5, jt)
    tf.maintain(5, tt)
    tf.parity.parity = None
    load_parity_rows(tf.parity, np.asarray(jf.parity.parity), 5,
                     device="cpu")
    if flip == "row":
        rows = np.asarray(jf.parity.parity).copy()
        rows[1, 0, 9] ^= 1 << 30
        jf.parity.parity = jnp.asarray(rows)
        load_parity_rows(tf.parity, rows, 5, device="cpu")
    else:
        blocks = (4,) if flip == "member" else (4, 12)
        for b in blocks:
            jf.inject_arena_bit_flip(block=b, word=2, bit=3)
            tf.inject_arena_bit_flip(block=b, word=2, bit=3)
    synd_t = tf.parity.syndromes_from_arena(tf.replicas.arena,
                                            tf.replicas.arena_layout)
    synd_j = np.asarray(jf.parity.syndromes_from_arena(
        jf.replicas.arena, jf.replicas.arena_layout))
    assert isinstance(synd_t, Syndromes)
    np.testing.assert_array_equal(synd_t.dense(), synd_j)
    rep_t = tf.parity.localize_corruption(synd_t)
    rep_j = jf.parity.localize_corruption(synd_j)
    assert [_strip(r) for r in rep_t] == [_strip(r) for r in rep_j]
    for a, b in zip(rep_t, rep_j):
        np.testing.assert_array_equal(a["delta"], b["delta"])
    assert tf.scrub(step=5) == jf.scrub(step=5)


# ---------------------------------------------------------------------------
# the advisor
# ---------------------------------------------------------------------------

OBS = [dict(drift_per_iter=0.3, x0_err=12.0, c=0.93, t_iter=0.01,
            t_dump_full=0.2, failure_rate=1e-3),
       dict(drift_per_iter=2.0, x0_err=1.0, c=0.99, t_iter=0.5,
            t_dump_full=5.0, failure_rate=0.05, loss_fraction=0.25,
            current_iter=700),
       dict(drift_per_iter=0.0, x0_err=3.0, c=0.5, t_iter=0.1,
            t_dump_full=1.0, failure_rate=0.1)]


def _close(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _close(a[k], b[k])
    elif isinstance(a, float):
        assert a == pytest.approx(b, rel=1e-12, abs=0)
    else:
        assert a == b


@pytest.mark.parametrize("obs", range(len(OBS)))
def test_advise_matches_reference(obs):
    pt, rt = tadv.advise(tadv.RunObservations(**OBS[obs]))
    pj, rj = jadv.advise(jadv.RunObservations(**OBS[obs]))
    assert (pt.fraction, pt.full_interval, pt.strategy.value, pt.norm) == \
        (pj.fraction, pj.full_interval, pj.strategy.value, pj.norm)
    _close(rt, rj)


MTBF = [({"device": 300.0, "host": 600.0, "rack": 1500.0}, 8, None, 4),
        ({"host": 50.0}, 20, 6 * 10 ** 7, 8),
        ({"host": 5.0, "rack": 10.0}, 50, 10 ** 9, 12)]


@pytest.mark.parametrize("case", range(len(MTBF)))
def test_advise_code_matches_reference(case):
    mtbf, window, budget, hosts = MTBF[case]
    kw = dict(window=window, model_bytes=10 ** 8, budget_bytes=budget,
              n_hosts=hosts)
    ct, rt = tadv.advise_code(mtbf, **kw)
    cj, rj = jadv.advise_code(mtbf, **kw)
    assert ct == cj
    _close(rt, rj)
    kw["budget_bytes"] = 2 ** 20              # nothing fits: both refuse
    for adv in (tadv, jadv):
        with pytest.raises(ValueError, match="no RS"):
            adv.advise_code(mtbf, **kw)


def test_observe_from_controller_matches_reference():
    class Ctl:
        stats = {"save_seconds": 0.6, "saves": 3}

        def __init__(self, policy):
            self.policy = policy
            self.block_drift = None
    losses = list(200.0 * 0.95 ** np.arange(40) + 5.0)
    ot = tadv.observe_from_controller(Ctl(TPolicy.scar()), losses, 0.02, 1e-3)
    oj = jadv.observe_from_controller(Ctl(JPolicy.scar()), losses, 0.02, 1e-3)
    _close(dataclasses.asdict(ot), dataclasses.asdict(oj))


# ---------------------------------------------------------------------------
# examples/correlated_failures.py, multi-erasure section
# ---------------------------------------------------------------------------

KW = dict(n=600, dim=64, n_classes=5, batch=200)   # the example's MLR
ITERS = 120


@pytest.fixture(scope="module")
def mlr():
    ref = jclassic.make_model("mlr", **KW)
    idx = {i: torch.from_numpy(np.asarray(jax.random.choice(
        jax.random.fold_in(jax.random.PRNGKey(0), i), KW["n"],
        (KW["batch"],), replace=False)).astype(np.int64))
        for i in range(1, ITERS + 1)}
    # the port fed the reference's batch draws (seed 0)
    port = dataclasses.replace(tclassic.make_model("mlr", device="cpu", **KW),
                               eps=ref.eps, draw=lambda gen, i: idx[i])
    return (ref, jrunner.run_clean(ref, ITERS)["losses"], port,
            trunner.run_clean(port, ITERS, device="cpu")["losses"])


@pytest.mark.parametrize("code", [dict(), dict(rs_parity=2)])
def test_correlated_failures_multi_erasure_matches_reference(mlr, code):
    """Hosts 0 and 2 (one per rack) die at step 15, elastic, XOR and
    RS(k, 2): equal tier counts, fallbacks and iteration cost; the losses
    within rtol 1e-4 (the frameworks order their matmuls differently)."""
    ref, clean_ref, port, clean_port = mlr
    kw = dict(fraction=0.25, full_interval=8, block_rows=ref.block_rows)
    jpol = JPolicy(strategy=JStrategy.ROUND_ROBIN,
                   recovery=JRecovery.PARTIAL, **kw)
    tpol = TPolicy(strategy=TStrategy.ROUND_ROBIN,
                   recovery=TRecovery.PARTIAL, **kw)
    trace = [("host", 0, 15), ("host", 2, 15)]
    want = jrunner.run_with_trace(
        ref, jpol, max_iters=ITERS, seed=0, clean_losses=clean_ref,
        trace=[JEvent(step=s, kind=k, index=i) for k, i, s in trace],
        fabric=JConfig(elastic=True, **TOPO, **code))
    got = trunner.run_with_trace(
        port, tpol, max_iters=ITERS, seed=0, clean_losses=clean_port,
        trace=[TEvent(step=s, kind=k, index=i) for k, i, s in trace],
        fabric=TConfig(elastic=True, **TOPO, **code), device="cpu")
    ev_t = next(e for e in got["events"] if not e.get("skipped"))
    ev_j = next(e for e in want["events"] if not e.get("skipped"))
    assert ev_t["tier_counts"] == ev_j["tier_counts"]
    assert ev_t["tier_fallbacks"] == ev_j["tier_fallbacks"]
    assert ev_t["placement"] == ev_j["placement"]
    assert got["iteration_cost"] == want["iteration_cost"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4)
    if code:
        assert ev_t["tier_fallbacks"] == []
        assert ev_t["applied_sq"] == 0.0
    else:
        assert len(ev_t["tier_fallbacks"]) > 0
