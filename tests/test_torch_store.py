"""The disk store (``checkpoint_io/store.py``), port against reference.

The same numpy inputs go through both packages' ``ShardedCheckpointStore``
(directly, or through ``FTController(store=...)`` with a fabric):

- the files the two write are byte-equal (shards, ``MANIFEST.json``,
  ``PARITY.json`` and the ``np.save`` parity files) on f32, bf16 and int8
  trees, in the tree layout, the domain-keyed tree layout and the arena
  segment layout, and after ``compact`` with and without re-keying;
- each package reads the other's files and gets the same values, bit for
  bit (the port into torch tensors on the store's device);
- the reference's store tests, run on the port: partial writes, the
  append log and its compaction, the missing-shard compaction, the arena
  store's re-key and one append per host, the domain-keyed partial read,
  the parity mirror's offline reconstruction, RS homes, the background
  writer's retries, and the controller's store lifecycle;
- the DISK tier: a fabric without replicas or parity loses two hosts,
  blocks whose running-checkpoint home died come back from the store,
  equal to the running checkpoint; ``must_reload`` rebuilds it from disk.
"""
import os
import shutil

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint_io import ShardedCheckpointStore as JStore
from repro.core.blocks import partition_pytree as j_partition
from repro.core.controller import FTController as JController
from repro.core.policy import CheckpointPolicy as JPolicy
from repro.core.policy import RecoveryMode as JRecovery
from repro.core.policy import SelectionStrategy as JStrategy
from repro.fabric import FabricConfig as JFabricConfig
from repro.fabric.domains import FailureDomainMap as JDomains
from repro.sharding.partition import block_device_homes as j_homes
from repro_torch.checkpoint_io import ShardedCheckpointStore
from repro_torch.core.blocks import partition_pytree
from repro_torch.core.controller import FTController
from repro_torch.core.policy import (CheckpointPolicy, RecoveryMode,
                                     SelectionStrategy)
from repro_torch.fabric import CheckpointFabric, FabricConfig
from repro_torch.fabric.domains import FailureDomainMap
from repro_torch.fabric.parity import ParityCodec, pack_frames
from repro_torch.fabric.placement import ClusterView
from repro_torch.interop import from_numpy_tree
from repro_torch.sharding.partition import block_device_homes
from repro_torch.telemetry.recorder import Recorder
from repro_torch.utils.tree import tree_leaves

DTYPES = {"f32": np.float32, "bf16": ml_dtypes.bfloat16, "i8": np.int8}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaf(rng, shape, dtype):
    if np.dtype(dtype).kind in "iu":
        return rng.integers(-100, 100, shape).astype(dtype)
    return rng.normal(size=shape).astype(np.float32).astype(dtype)


def _tree(dtype=np.float32, seed=0):
    """Multi-block, single-block and tail leaves and a scalar."""
    rng = np.random.default_rng(seed)
    return {"w": _leaf(rng, (50, 6), dtype), "emb": _leaf(rng, (33, 8), dtype),
            "b": _leaf(rng, (5,), dtype), "s": _leaf(rng, (), dtype)}


def _drift(tree, seed):
    rng = np.random.default_rng(100 + seed)
    out = {}
    for k, x in tree.items():
        if np.dtype(x.dtype).kind in "iu":
            d = rng.integers(-3, 4, x.shape)
            out[k] = np.clip(x.astype(np.int16) + d, -128, 127).astype(x.dtype)
        else:
            out[k] = (x.astype(np.float32) + rng.normal(size=x.shape)
                      .astype(np.float32)).astype(x.dtype)
    return out


def _jax(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _torch(tree):
    return from_numpy_tree(tree, "cpu")


def _files(root) -> dict:
    out = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            p = os.path.join(dirpath, name)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def _bits(x) -> np.ndarray:
    """Raw bytes of a torch tensor or a jax/numpy array."""
    if isinstance(x, torch.Tensor):
        from repro_torch.checkpoint_io.store import host_bytes
        return host_bytes(x)
    return np.ascontiguousarray(np.asarray(x)).reshape(-1).view(np.uint8)


def _same_values(torch_tree, other_tree):
    t = tree_leaves(torch_tree)
    if isinstance(other_tree, dict) and not isinstance(
            next(iter(other_tree.values())), torch.Tensor):
        o = [other_tree[k] for k in sorted(other_tree)]
    else:
        o = tree_leaves(other_tree)
    assert len(t) == len(o)
    for a, b in zip(t, o):
        assert tuple(a.shape) == tuple(np.shape(b))
        np.testing.assert_array_equal(_bits(a), _bits(b))


def _policies(fraction=0.25, block_rows=16):
    kw = dict(fraction=fraction, full_interval=1, block_rows=block_rows)
    return (JPolicy(strategy=JStrategy.ROUND_ROBIN,
                    recovery=JRecovery.PARTIAL, **kw),
            CheckpointPolicy(strategy=SelectionStrategy.ROUND_ROBIN,
                             recovery=RecoveryMode.PARTIAL, **kw))


# ---------------------------------------------------------------------------
# byte equality and cross-reads
# ---------------------------------------------------------------------------

def _direct_pair(tmp_path, dtype, keyed: bool):
    """Both stores over the same tree, initialized and given two partial
    writes (one background), the tree layout."""
    tree = _tree(dtype)
    jp, tp = _jax(tree), _torch(tree)
    jpart, tpart = j_partition(jp, 8), partition_pytree(tp, 8)
    kw_j, kw_t = {}, {}
    if keyed:
        kw_j = dict(homes=j_homes(jpart, 8), domains=JDomains(8, 2, 2))
        kw_t = dict(homes=block_device_homes(tpart, 8),
                    domains=FailureDomainMap(8, 2, 2))
        np.testing.assert_array_equal(kw_j["homes"], kw_t["homes"])
    js = JStore(str(tmp_path / "ref"))
    ts = ShardedCheckpointStore(str(tmp_path / "port"), device="cpu")
    js.init(jp, jpart, **kw_j)
    ts.init(tp, tpart, **kw_t)
    for step, bg in ((3, True), (5, False)):
        new = _drift(tree, step)
        mask = np.zeros((tpart.total_blocks,), bool)
        mask[step % tpart.total_blocks::3] = True
        js.write_blocks(mask, _jax(new), step=step, background=bg)
        ts.write_blocks(mask, _torch(new), step=step, background=bg)
        # a background write and a later synchronous one may land in
        # either order: settle each before the next
        js.flush()
        ts.flush()
    return js, ts


@pytest.mark.parametrize("keyed", [False, True], ids=["flat", "domains"])
@pytest.mark.parametrize("dtype", list(DTYPES), ids=list(DTYPES))
def test_tree_layout_files_byte_equal_and_cross_read(tmp_path, dtype, keyed):
    js, ts = _direct_pair(tmp_path, DTYPES[dtype], keyed)
    assert _files(js.root) == _files(ts.root)
    _same_values(ts.read_all(), js.read_all())
    np.testing.assert_array_equal(ts.saved_iters(), js.saved_iters())
    # cross-reads: each package over the other's files
    ref_root, port_root = js.root, ts.root
    js.root, ts.root = port_root, ref_root
    _same_values(ts.read_all(), js.read_all())
    mask = np.zeros((ts.partition.total_blocks,), bool)
    mask[1::2] = True
    _same_values(ts.read_blocks(mask), js.read_blocks(mask))


def _controller_pair(tmp_path, dtype, steps=3, elastic=False, **fab):
    """Both controllers in arena mode over the same tree and drifts, each
    with a store: maintain and a round-robin save a step."""
    tree = _tree(dtype)
    jpol, tpol = _policies()
    js = JStore(str(tmp_path / "ref"))
    ts = ShardedCheckpointStore(str(tmp_path / "port"), device="cpu")
    jc = JController(_jax(tree), jpol, store=js,
                     fabric=JFabricConfig(use_pallas=False, elastic=elastic,
                                          **fab))
    tc = FTController(_torch(tree), tpol, store=ts,
                      fabric=FabricConfig(elastic=elastic, **fab),
                      device="cpu")
    live = tree
    for step in range(1, steps + 1):
        live = _drift(live, step)
        jl, tl = _jax(live), _torch(live)
        jc.maintain(step, jl)
        jc.checkpoint_now(step, jl)
        tc.maintain(step, tl)
        tc.checkpoint_now(step, tl)
    js.flush()
    ts.flush()
    return jc, tc, live


@pytest.mark.parametrize("dtype", list(DTYPES), ids=list(DTYPES))
def test_arena_layout_files_byte_equal_and_cross_read(tmp_path, dtype):
    """The controllers' mirrors: arena segments, domain-keyed by the
    fabric, the parity mirror after every save."""
    jc, tc, _ = _controller_pair(tmp_path, DTYPES[dtype])
    js, ts = jc.store, tc.store
    assert tc.arena_ready and ts.arena_layout is not None
    files = _files(ts.root)
    assert "PARITY.json" in files and any(
        k.endswith(".npy") for k in files)
    assert _files(js.root) == files
    assert tc.stats["bytes_mirrored"] == jc.stats["bytes_mirrored"] > 0
    _same_values(ts.read_all(), tc.ckpt.values)
    _same_values(ts.read_all(), js.read_all())
    parity, meta = ts.read_parity()
    jparity, jmeta = js.read_parity()
    assert meta == jmeta
    np.testing.assert_array_equal(parity.numpy(), np.asarray(jparity))
    np.testing.assert_array_equal(parity.numpy(),
                                  tc.fabric.parity.parity.numpy())
    ref_root, port_root = js.root, ts.root
    js.root, ts.root = port_root, ref_root
    _same_values(ts.read_all(), js.read_all())
    dn = tc.fabric.redundancy_nbytes(store=ts)
    assert dn["store_disk"] == jc.fabric.redundancy_nbytes(
        store=js)["store_disk"]
    assert dn["store_disk"] >= dn["store_disk_live"] > 0


@pytest.mark.parametrize("rekey", [False, True], ids=["plain", "rekey"])
def test_compaction_byte_equal(tmp_path, rekey):
    """After a host loss on an elastic fabric, compaction (re-keyed to the
    current homes or not) leaves byte-equal files that read back as the
    running checkpoint; a save after it lands in the new keying."""
    jc, tc, live = _controller_pair(tmp_path, np.float32, elastic=True)
    jl, _ = jc.on_domain_event(_jax(live), "host", 0, step=3)
    tl, _ = tc.on_domain_event(_torch(live), "host", 0, step=3)
    np.testing.assert_array_equal(tc.fabric.view.homes, jc.fabric.view.homes)
    js, ts = jc.store, tc.store
    kw_j = kw_t = {}
    if rekey:
        kw_j = dict(rekey_homes=jc.fabric.view.homes,
                    domains=jc.fabric.domains)
        kw_t = dict(rekey_homes=tc.fabric.view.homes,
                    domains=tc.fabric.domains)
    assert ts.compact(**kw_t) == js.compact(**kw_j) > 0
    assert _files(js.root) == _files(ts.root)
    _same_values(ts.read_all(), tc.ckpt.values)
    if rekey:
        np.testing.assert_array_equal(
            ts.host_of_block, tc.fabric.domains.host_of(tc.fabric.view.homes))
    live = _drift(live, 9)
    jc.maintain(4, _jax(live))
    jc.checkpoint_now(4, _jax(live))
    tc.maintain(4, _torch(live))
    tc.checkpoint_now(4, _torch(live))
    js.flush()
    ts.flush()
    assert _files(js.root) == _files(ts.root)
    _same_values(ts.read_all(), tc.ckpt.values)


# ---------------------------------------------------------------------------
# the reference's store tests, on the port
# ---------------------------------------------------------------------------

def _wb():
    rng = np.random.default_rng(3)
    return {"w": np.arange(60.0, dtype=np.float32).reshape(20, 3),
            "b": rng.normal(size=(4,)).astype(np.float32)}


def test_store_roundtrip_partial_writes(tmp_path):
    params = _torch(_wb())
    part = partition_pytree(params, block_rows=8)
    store = ShardedCheckpointStore(str(tmp_path), device="cpu")
    store.init(params, part)
    newp = {k: v * 10 for k, v in params.items()}
    mask = np.zeros((part.total_blocks,), bool)
    w_leaf = [l for l in part.leaves if l.name == "['w']"][0]
    mask[w_leaf.offset + 1] = True   # rows 8..15 of w
    store.write_blocks(mask, newp, step=5, background=True)
    store.flush()
    back = store.read_all()
    assert back["w"].device.type == "cpu"
    torch.testing.assert_close(back["w"][:8], params["w"][:8], rtol=0, atol=0)
    torch.testing.assert_close(back["w"][8:16], newp["w"][8:16], rtol=0,
                               atol=0)
    torch.testing.assert_close(back["b"], params["b"], rtol=0, atol=0)
    iters = store.saved_iters()
    assert iters[w_leaf.offset + 1] == 5 and iters[w_leaf.offset] == 0


def test_store_packed_append_log_and_compaction(tmp_path):
    params = _torch(_wb())
    part = partition_pytree(params, block_rows=8)
    store = ShardedCheckpointStore(str(tmp_path), device="cpu")
    store.init(params, part)
    assert os.path.exists(os.path.join(str(tmp_path), "blocks.g0000.shard"))
    base = store.disk_nbytes()
    assert base["shard"] == base["live"] > 0
    w_leaf = [l for l in part.leaves if l.name == "['w']"][0]
    mask = np.zeros((part.total_blocks,), bool)
    mask[w_leaf.offset] = True
    for step in (1, 2, 3):
        newp = {k: v * (step + 1) for k, v in params.items()}
        store.write_blocks(mask, newp, step=step, background=False)
    grown = store.disk_nbytes()
    blk_bytes = 8 * w_leaf.row_width * 4
    assert grown["shard"] == base["shard"] + 3 * blk_bytes
    assert grown["live"] == base["live"]
    assert torch.equal(store.read_all()["w"][:8], params["w"][:8] * 4)
    assert store.compact() == 3 * blk_bytes
    assert os.path.exists(os.path.join(str(tmp_path), "blocks.g0001.shard"))
    assert not os.path.exists(os.path.join(str(tmp_path),
                                           "blocks.g0000.shard"))
    after = store.disk_nbytes()
    assert after["shard"] == after["live"] == base["live"]
    assert torch.equal(store.read_all()["w"][:8], params["w"][:8] * 4)
    assert store.saved_iters()[w_leaf.offset] == 3


def test_compact_drops_segments_of_missing_shards(tmp_path):
    import json
    params = {"w": torch.arange(64, dtype=torch.float32).reshape(16, 4)}
    part = partition_pytree(params, 4)
    dm = FailureDomainMap(n_devices=8, devices_per_host=2, hosts_per_rack=2)
    homes = block_device_homes(part, 8)
    store = ShardedCheckpointStore(str(tmp_path), device="cpu")
    store.init(params, part, homes=homes, domains=dm)
    lost_host = int(dm.host_of(homes[0]))
    shutil.rmtree(os.path.join(str(tmp_path), f"host_{lost_host:04d}"))
    store.compact()
    with open(os.path.join(str(tmp_path), "MANIFEST.json")) as f:
        segments = json.load(f)["segments"]
    lost = [g for g in range(part.total_blocks)
            if int(dm.host_of(homes[g])) == lost_host]
    assert lost and all(segments[g] is None for g in lost)
    back = store.read_all()["w"].reshape(-1, 4, 4)
    for g in range(part.total_blocks):
        want = torch.zeros(4, 4) if g in lost else params["w"][4 * g:4 * g + 4]
        assert torch.equal(back[g], want)


def test_arena_store_roundtrip_and_rekey(tmp_path):
    _, tc, live = _controller_pair(tmp_path, np.float32, elastic=True)
    store = tc.store
    _same_values(store.read_all(), tc.ckpt.values)
    mask = np.zeros((tc.partition.total_blocks,), bool)
    mask[0] = True
    w = tree_leaves(store.read_blocks(mask))[0]
    want = tree_leaves(tc.ckpt.values)[0]
    assert torch.equal(w[:16], want[:16])
    tl, _ = tc.on_domain_event(_torch(live), "host", 0, step=3)
    assert store.compact(rekey_homes=tc.fabric.view.homes,
                         domains=tc.fabric.domains) >= 0
    _same_values(store.read_all(), tc.ckpt.values)
    np.testing.assert_array_equal(
        store.host_of_block, tc.fabric.domains.host_of(tc.fabric.view.homes))


def test_arena_store_one_append_write_per_host(tmp_path, monkeypatch):
    params = _torch(_tree())
    _, pol = _policies(fraction=0.5)
    store = ShardedCheckpointStore(str(tmp_path), device="cpu")
    ctl = FTController(params, pol, store=store, fabric=FabricConfig(),
                       device="cpu")
    writes = []
    orig = ShardedCheckpointStore._do_write

    def spy(self, jobs, step):
        writes.append(len({self._shard_path(seg) for seg, _ in jobs}))
        return orig(self, jobs, step)

    monkeypatch.setattr(ShardedCheckpointStore, "_do_write", spy)
    live = _torch(_drift(_tree(), 1))
    ctl.maintain(1, live)
    ctl.checkpoint_now(1, live)
    store.flush()
    assert writes and all(n <= 4 for n in writes)


def _wide(rows=256, width=6, seed=7):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(rows, width)).astype(np.float32),
            "b": rng.normal(size=(8,)).astype(np.float32)}


def test_store_domain_keyed_layout_and_partial_read(tmp_path):
    params = _torch(_wide())
    part = partition_pytree(params, 16)
    dm = FailureDomainMap(8, 2, 2)
    homes = block_device_homes(part, 8)
    store = ShardedCheckpointStore(str(tmp_path), device="cpu")
    store.init(params, part, homes=homes, domains=dm)
    hosts = np.asarray(dm.host_of(homes))
    for h in np.unique(hosts):
        names = os.listdir(os.path.join(str(tmp_path), f"host_{h:04d}"))
        assert any(n.startswith("blocks.") and n.endswith(".shard")
                   for n in names)
    for gid in range(part.total_blocks):
        assert os.path.dirname(store._shard_path(gid)).endswith(
            f"host_{hosts[gid]:04d}")
    mask = hosts == 2
    got, full = store.read_blocks(mask), store.read_all()
    wleaf = next(l for l in part.leaves if l.name.endswith("'w']"))
    masked = [b for b in range(wleaf.n_blocks) if mask[wleaf.offset + b]]
    assert masked
    for b in range(wleaf.n_blocks):
        rows = slice(b * 16, (b + 1) * 16)
        want = full["w"][rows] if b in masked else torch.zeros(16, 6)
        assert torch.equal(got["w"][rows], want)
    _, present = store.read_surviving([1])
    np.testing.assert_array_equal(present, hosts != 1)


def test_store_parity_mirror_offline_reconstruction(tmp_path):
    """A host's shard dies; its blocks reconstruct from the surviving
    shards and the disk parity alone, bit for bit."""
    params = _torch(_wide())
    part = partition_pytree(params, 16)
    dm = FailureDomainMap(8, 2, 2)
    homes = block_device_homes(part, 8)
    codec = ParityCodec(part, ClusterView(dm, homes), group_size=3)
    codec.encode(0, params)
    store = ShardedCheckpointStore(str(tmp_path), device="cpu")
    store.init(params, part, homes=homes, domains=dm)
    assert store.write_parity(0, codec.parity, codec.parity_homes,
                              domains=dm, members=codec.members) > 0
    parity, meta = store.read_parity()
    assert meta["step"] == 0 and parity.shape[0] == codec.n_groups
    shutil.rmtree(os.path.join(str(tmp_path), "host_0001"))
    vals, present = store.read_surviving([1])
    frames = pack_frames(vals, part, codec.layout)
    want = pack_frames(params, part, codec.layout)
    checked = 0
    for j, ids in enumerate(meta["members"]):
        ids = np.asarray(ids, np.int64)
        missing = ids[~present[ids]]
        if missing.size != 1:
            continue
        acc = parity[j].clone()
        for b in ids[present[ids]]:
            acc ^= frames[b]
        assert torch.equal(acc, want[int(missing[0])])
        checked += 1
    assert checked > 0


def test_write_parity_rs_homes_roundtrip(tmp_path):
    params = _torch(_wide())
    part = partition_pytree(params, 16)
    fab = CheckpointFabric(part, FabricConfig(rs_parity=2))
    fab.maintain(2, params)
    store = ShardedCheckpointStore(str(tmp_path / "mirror"), device="cpu")
    store.init(params, part, homes=fab.view.homes, domains=fab.domains)
    n = store.write_parity(2, fab.parity.parity, fab.parity.parity_homes,
                           domains=fab.domains, members=fab.parity.members)
    assert n == fab.parity.parity.numel() * 4
    parity, meta = store.read_parity()
    assert torch.equal(parity, fab.parity.parity)
    assert meta["n_parity"] == 2
    assert np.asarray(meta["parity_homes"]).shape == \
        fab.parity.parity_homes.shape


def _flaky_store(tmp_path, n_fail):
    params = _torch(_wide(rows=64, width=4))
    part = partition_pytree(params, 16)
    store = ShardedCheckpointStore(str(tmp_path / "s"), device="cpu")
    store._retry_base_delay = 1e-4
    rec = Recorder()
    store.attach_recorder(rec)
    store.init(params, part)
    real = store._do_write
    left = {"n": n_fail}

    def flaky(jobs, step):
        if left["n"]:
            left["n"] -= 1
            raise OSError("transient shared-fs blip")
        return real(jobs, step)

    store._do_write = flaky
    store.write_blocks(torch.ones((part.total_blocks,), dtype=torch.bool),
                       params, step=1, background=True)
    return store, rec, params, real


def test_store_background_write_retries_then_succeeds(tmp_path):
    store, rec, params, real = _flaky_store(tmp_path, 2)
    store.flush()   # two transient failures are retried away
    retried = [e for e in rec.events if e["kind"] == "store_write_retried"]
    assert [e["attempt"] for e in retried] == [1, 2]
    assert all(e["delay_seconds"] > 0 for e in retried)
    assert not [e for e in rec.events if e["kind"] == "store_write_failed"]
    store._do_write = real
    _same_values(store.read_all(), params)


def test_store_background_write_fails_after_retry_budget(tmp_path):
    store, rec, _, _ = _flaky_store(tmp_path, 99)
    with pytest.raises(RuntimeError, match="background checkpoint write") \
            as ei:
        store.flush()
    assert "attempts" in str(ei.value.__cause__)
    assert isinstance(ei.value.__cause__.__cause__, OSError)
    retried = [e for e in rec.events if e["kind"] == "store_write_retried"]
    assert len(retried) == store._retry_limit
    assert [e for e in rec.events if e["kind"] == "store_write_failed"]


def test_controller_with_persistent_store_lifecycle(tmp_path):
    """``scar(0.25, 8)`` without a fabric: a save every 2 iterations, 4 in
    8; the disk mirror equals the running checkpoint after a recovery."""
    params = {"w": torch.arange(2000, dtype=torch.float32).reshape(500, 4)}
    store = ShardedCheckpointStore(str(tmp_path), device="cpu")
    ctl = FTController(params, CheckpointPolicy.scar(0.25, 8), store=store,
                       device="cpu")
    p = params
    for step in range(1, 9):
        p = {"w": p["w"] + 1.0}
        ctl.maybe_checkpoint(step, p)
    _, info = ctl.on_failure(p, ctl.sample_failure(0.5))
    assert info["partial_sq"] <= info["full_sq"]
    store.flush()
    assert torch.equal(store.read_all()["w"], ctl.ckpt.values["w"])
    assert ctl.stats["saves"] == 4
    assert ctl.stats["bytes_mirrored"] > 0


# ---------------------------------------------------------------------------
# the DISK tier
# ---------------------------------------------------------------------------

def test_disk_tier_serves_blocks_whose_checkpoint_home_died(tmp_path):
    """No replicas, no parity: a two-host loss sends the blocks whose
    running-checkpoint home died to DISK. Both packages plan the same
    tiers; the port's DISK blocks come back from the store through one
    read of the masked blocks, equal to the running checkpoint."""
    tree = _wide()
    jpol, tpol = _policies()
    fab = dict(replicate=False, parity=False)
    js = JStore(str(tmp_path / "ref"))
    ts = ShardedCheckpointStore(str(tmp_path / "port"), device="cpu")
    jc = JController(_jax(tree), jpol, store=js,
                     fabric=JFabricConfig(use_pallas=False, **fab))
    tc = FTController(_torch(tree), tpol, store=ts,
                      fabric=FabricConfig(**fab), device="cpu")
    live = tree
    for step in (1, 2):
        live = _drift(live, step)
        jc.maintain(step, _jax(live))
        jc.checkpoint_now(step, _jax(live))
        tc.maintain(step, _torch(live))
        tc.checkpoint_now(step, _torch(live))
    live = _drift(live, 3)
    reads = []
    real = ts.read_blocks

    def spy(mask):
        reads.append(np.asarray(mask).copy())
        return real(mask)

    ts.read_blocks = spy
    _, jinfo = jc.on_domain_events(_jax(live), [("host", 0), ("host", 2)],
                                   step=3)
    tlive = _torch(live)
    rec, info = tc.on_domain_events(tlive, [("host", 0), ("host", 2)],
                                    step=3)
    assert info["tier_counts"] == jinfo["tier_counts"]
    assert info["tier_counts"]["DISK"] > 0
    assert len(reads) == 1
    disk = reads[0]
    assert int(disk.sum()) == info["tier_counts"]["DISK"]
    assert _files(js.root) == _files(ts.root)
    br = tc.partition.block_rows
    for leaf, x, ck in zip(tc.partition.leaves, tree_leaves(rec),
                           tree_leaves(tc.ckpt.values)):
        for b in range(leaf.n_blocks):
            if disk[leaf.offset + b]:
                rows = slice(b * br, (b + 1) * br)
                assert torch.equal(x[rows], ck[rows])
    assert info["tier_sq"]["DISK"] == pytest.approx(
        jinfo["tier_sq"]["DISK"], rel=1e-5)


def test_must_reload_rebuilds_the_checkpoint_from_disk(tmp_path):
    """With the in-memory checkpoint gone (``must_reload``), recovery
    reads the whole mirror: a PARTIAL recovery then restores the disk's
    values, equal to what the checkpoint held."""
    params = _torch(_wide())
    store = ShardedCheckpointStore(str(tmp_path), device="cpu")
    ctl = FTController(params, CheckpointPolicy.scar(0.25, 8), store=store,
                       device="cpu")
    p = params
    for step in range(1, 5):
        p = {k: v + 0.5 for k, v in p.items()}
        ctl.maybe_checkpoint(step, p)
    want = {k: v.clone() for k, v in ctl.ckpt.values.items()}
    ctl.ckpt = ctl.ckpt.__class__({k: torch.zeros_like(v)
                                   for k, v in want.items()},
                                  ctl.ckpt.saved_iter, ctl.ckpt.rr_cursor)
    store.must_reload = True
    lost = torch.ones((ctl.partition.total_blocks,), dtype=torch.bool)
    rec, _ = ctl.on_failure(p, lost)
    for k in want:
        assert torch.equal(rec[k], want[k])
