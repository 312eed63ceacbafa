"""The ``Server`` on a mesh: every family's prefill and decode split over
the ``model`` axis, against the reference's serving on a forced 4-device
CPU mesh.

The weights and the prompts are drawn here (the port's ``init_params``
from a seed, numpy prompts) and handed to both packages. The reference
runs in one subprocess (``XLA_FLAGS`` forcing 4 CPU devices, a ``(2, 2)``
``("data", "model")`` mesh, the weights placed by its
``param_partition_specs`` and the batch by ``batch_partition_specs``);
the port runs 4 gloo ranks in subprocesses beside it (one torch thread
each, a ``file://`` rendezvous in the test's directory). Reduced configs,
f32, batch 4, prompt 32 (80 for qwen2-1.5b: past its 64-token window),
4 new tokens:

- the prefill's and every decode step's logits of each rank's data shard
  within rtol 1e-4 and atol 1e-4 of the reference's mesh run (under
  ``kv_quant`` the decode steps run on the reference's own int8 cache
  after its prefill, as ``test_torch_perf_variants.py`` does: a value one
  count off moves a step's logits by up to 3.5e-4);
- greedy tokens equal to the reference's mesh tokens, on every rank
  (``Server.generate`` returns the whole batch's); for qwen3-moe and
  llama4-maverick the reference's mesh tokens differ from its one-device
  tokens (the MoE's capacity is the data shard's) and the port's with
  them;
- each rank's cache or state slice (``partition.state_slices``) against
  the reference's same shard of it, after the prefill and after the last
  step (int8 values within one count: ``quantize_kv``'s scale can sit one
  ulp off under the reference's jit);
- qwen2-1.5b's ring cache (``cache_spec(use_window=True)``, a banded
  prefill over the rank's heads), with and without ``kv_quant``;
- a ``temperature > 0`` generate, each rank's generator seeded
  differently: every rank returns the same tokens.

In process: a one-position mesh serves the ctx-less bits;
``state_slices`` cuts each leaf as the reference's
``_state_spec_for_leaf`` places it; kv heads that do not split are shared
by the positions whose query heads read them, and query heads that do not
split raise.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.sharding import partition as jp
from repro_torch.configs import get_config
from repro_torch.interop import from_numpy_tree, to_numpy_tree
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import get_model
from repro_torch.sharding import partition as tp
from repro_torch.training.serve import Server
from repro_torch.utils.tree import flatten_with_path, keystr

SRC = Path(__file__).resolve().parents[1] / "src"
# (case, config, overrides, prompt)
CASES = (("qwen2", "qwen2-1.5b", {}, 80),
         ("qwen2-kvq", "qwen2-1.5b", {"kv_quant": True}, 80),
         ("qwen3-moe", "qwen3-moe-235b-a22b", {}, 32),
         ("llama4", "llama4-maverick-400b-a17b", {}, 32),
         ("internvl2", "internvl2-76b", {}, 32),
         ("mamba2", "mamba2-370m", {}, 32),
         ("zamba2", "zamba2-1.2b", {}, 32),
         ("whisper", "whisper-medium", {}, 32))
NAMES = tuple(c[0] for c in CASES)
MOE = ("qwen3-moe", "llama4")
RING = ("qwen2", "qwen2-kvq")
B, N_NEW = 4, 4
DEADLINE = 200
RTOL = ATOL = 1e-4
SLACK = 64      # the serve prefill's empty cache slots

REF = r'''
import dataclasses, pickle, sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding
from repro.configs import get_config
from repro.launch.mesh import make_mesh_compat
from repro.models import get_model, transformer
from repro.sharding.partition import (batch_partition_specs, make_dist_ctx,
                                      named_shardings, single_device_ctx)
from repro.training.serve import Server

out = sys.argv[1]
inputs = pickle.load(open(f"{out}/inputs.pkl", "rb"))
mesh = make_mesh_compat((2, 2), ("data", "model"))
ctx = make_dist_ctx(mesh)
np_ = lambda t: jax.tree_util.tree_map(np.asarray, t)
greedy = lambda lg: jnp.argmax(lg[:, -1], axis=-1)[:, None].astype(jnp.int32)
res = {}


def run(pre, dec, params, batch):
    logits, cache = pre(params, batch)
    r = {"logits": [np.asarray(logits)], "cache0": np_(cache)}
    toks = [greedy(logits)]
    for _ in range(%(n_new)d - 1):
        logits, cache = dec(params, cache, toks[-1])
        r["logits"].append(np.asarray(logits))
        toks.append(greedy(logits))
    r["cache"] = np_(cache)
    r["tokens"] = np.asarray(jnp.concatenate(toks, axis=1))
    return r


for case, name, over, S in %(cases)r:
    cfg = dataclasses.replace(get_config(name, reduced=True), **over)
    ops = get_model(cfg)
    params_np, batch_np = inputs[case]
    params = jax.device_put(params_np, named_shardings(params_np, ctx))
    batch = jax.device_put(batch_np, jax.tree_util.tree_map(
        lambda s: NamedSharding(mesh, s),
        batch_partition_specs(batch_np, ctx),
        is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec)))
    r = run(jax.jit(lambda p, b: ops.prefill(p, b, cfg, ctx)),
            jax.jit(lambda p, c, t: ops.decode_step(p, c, t, cfg, ctx)),
            params, batch)
    r["server"] = np.asarray(Server(cfg, ctx, params).generate(batch,
                                                               %(n_new)d))
    if case in %(moe)r:
        one = jax.tree_util.tree_map(jnp.asarray, params_np)
        r["one_device"] = np.asarray(Server(cfg, single_device_ctx(), one)
                                     .generate(batch_np, %(n_new)d))
    if case in %(ring)r:
        spec = transformer.cache_spec(cfg, S, use_window=True)
        r["ring"] = run(
            jax.jit(lambda p, b: transformer.prefill(p, b, cfg, ctx, spec)),
            jax.jit(lambda p, c, t: transformer.decode_step(p, c, t, cfg,
                                                            ctx, spec)),
            params, batch)
    res[case] = r
pickle.dump(res, open(f"{out}/ref.pkl", "wb"))
print("REF-OK")
''' % {"cases": CASES, "n_new": N_NEW, "moe": MOE, "ring": RING}

RANK = r'''
import dataclasses, datetime, pickle, sys
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
rank, world, rdv, job, out = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], sys.argv[4], sys.argv[5])
dist.init_process_group("gloo", init_method=f"file://{rdv}", rank=rank,
                        world_size=world,
                        timeout=datetime.timedelta(seconds=120))
from repro_torch.configs import get_config
from repro_torch.distributed import collectives
from repro_torch.interop import from_numpy_tree, to_numpy_tree
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import get_model, transformer
from repro_torch.sharding.partition import (batch_rows, make_dist_ctx,
                                            model_slices, state_slices)
from repro_torch.training.serve import Server

collectives.CHUNK_BYTES = 1 << 16
mesh = make_host_mesh(model=2)
ctx = make_dist_ctx(mesh)
inputs = pickle.load(open(f"{out}/inputs.pkl", "rb"))
res = {"rank": rank, "coords": list(mesh.coords())}


def greedy(lg):
    return torch.argmax(lg[:, -1], dim=-1)[:, None].to(torch.int32)


def run(pre, dec, shard):
    logits, cache = pre(shard)
    r = {"logits": [logits.numpy()], "cache0": to_numpy_tree(cache)}
    toks = [greedy(logits)]
    for _ in range(%(n_new)d - 1):
        logits, cache = dec(cache, toks[-1])
        r["logits"].append(logits.numpy())
        toks.append(greedy(logits))
    r["cache"] = to_numpy_tree(cache)
    r["tokens"] = torch.cat(toks, dim=1).numpy()
    return r


def on_ref_cache(cfg, params, spec, want, lo, hi):
    """Decode steps from the reference's own cache after its prefill (this
    rank's slice of it), fed the reference's tokens: the logits."""
    cache = from_numpy_tree(want["cache0"], "cpu",
                            state_slices(want["cache0"], ctx))
    toks = torch.from_numpy(want["tokens"][lo:hi].copy())
    got = []
    for i in range(%(n_new)d - 1):
        logits, cache = transformer.decode_step(params, cache,
                                                toks[:, i:i + 1], cfg, spec,
                                                ctx)
        got.append(logits.numpy())
    return got


with torch.no_grad():
    for case, name, over, S in %(cases)r:
        if job == "kvq" and not over.get("kv_quant"):
            continue
        cfg = dataclasses.replace(get_config(name, reduced=True), **over)
        ops = get_model(cfg)
        params_np, batch_np = inputs[case]
        params = from_numpy_tree(params_np, "cpu",
                                 model_slices(params_np, ctx))
        batch = from_numpy_tree(batch_np, "cpu")
        lo, hi = batch_rows(%(B)d, ctx)
        shard = {k: v[lo:hi] for k, v in batch.items()}
        if job == "kvq":
            ref = pickle.load(open(f"{out}/ref.pkl", "rb"))[case]
            S_all = S + %(slack)d
            res[case] = {
                "linear": on_ref_cache(cfg, params, transformer.CacheSpec(
                    S_all, False), ref, lo, hi),
                "ring": on_ref_cache(cfg, params, transformer.cache_spec(
                    cfg, S, use_window=True), ref["ring"], lo, hi)}
            continue
        collectives.reset_stats()
        r = run(lambda b: ops.prefill(params, b, cfg, ctx),
                lambda c, t: ops.decode_step(params, c, t, cfg, ctx), shard)
        r["stats"] = sorted(collectives.STATS)
        srv = Server(cfg, params, device="cpu", ctx=ctx)
        r["server"] = srv.generate(batch, %(n_new)d).numpy()
        r["sampled"] = srv.generate(
            batch, %(n_new)d, temperature=1.0,
            generator=torch.Generator().manual_seed(100 + rank)).numpy()
        if case in %(ring)r:
            spec = transformer.cache_spec(cfg, S, use_window=True)
            r["ring"] = run(
                lambda b: transformer.prefill(params, b, cfg, spec, ctx),
                lambda c, t: transformer.decode_step(params, c, t, cfg,
                                                     spec, ctx), shard)
        res[case] = r
pickle.dump(res, open(f"{out}/{job}_{rank}.pkl", "wb"))
dist.destroy_process_group()
''' % {"cases": CASES, "n_new": N_NEW, "ring": RING, "B": B, "slack": SLACK}


def _config(case: str):
    _, name, over, _ = next(c for c in CASES if c[0] == case)
    return dataclasses.replace(get_config(name, reduced=True), **over)


def _inputs() -> dict:
    """Each case's weights (the port's ``init_params`` from a seed) and
    prompts (numpy), as numpy trees."""
    out = {}
    for k, (case, _, _, S) in enumerate(CASES):
        cfg = _config(case)
        params = get_model(cfg).init_params(
            torch.Generator().manual_seed(40 + k), cfg, device="cpu")
        rng = np.random.default_rng(60 + k)
        batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(
            np.int32)}
        if cfg.family == "vlm":
            batch["patches"] = rng.standard_normal(
                (B, cfg.n_patches, cfg.vit_dim)).astype(np.float32)
        if cfg.family == "audio":
            batch["frames"] = rng.standard_normal(
                (B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
        out[case] = (to_numpy_tree(params), batch)
    return out


def _reference(out: Path) -> dict:
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.run([sys.executable, "-c", REF, str(out)],
                          capture_output=True, text=True, timeout=DEADLINE,
                          env=env)
    assert proc.returncode == 0 and "REF-OK" in proc.stdout, (
        f"the reference's subprocess failed:\n{proc.stderr[-4000:]}")
    return pickle.load(open(out / "ref.pkl", "rb"))


def _ranks(out: Path, job: str, world: int = 4) -> list:
    """The port's ranks running ``job``; their reports in rank order.
    Fails when a rank fails or the ranks outlive ``DEADLINE`` seconds."""
    (out / "rank.py").write_text(RANK)
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1",
               GLOO_SOCKET_IFNAME="lo")
    procs = [subprocess.Popen(
        [sys.executable, str(out / "rank.py"), str(r), str(world),
         str(out / f"rdv_{job}"), job, str(out)], env=env,
        stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    end = time.monotonic() + DEADLINE
    logs = []
    try:
        for p in procs:
            o, _ = p.communicate(timeout=max(1.0, end - time.monotonic()))
            logs.append(o)
    except subprocess.TimeoutExpired:
        pytest.fail(f"the ranks did not finish in {DEADLINE} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
    return [pickle.load(open(out / f"{job}_{r}.pkl", "rb"))
            for r in range(world)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's mesh run and the port's 4 ranks, side by side on
    the same inputs; then, for the int8 cache, the ranks' decode steps on
    the reference's own cache (``kvq``)."""
    out = tmp_path_factory.mktemp("mesh_serve")
    pickle.dump(_inputs(), open(out / "inputs.pkl", "wb"))
    with ThreadPoolExecutor(2) as pool:
        ref = pool.submit(_reference, out)
        ranks = pool.submit(_ranks, out, "serve")
        ref, ranks = ref.result(), ranks.result()
    for r, k in zip(ranks, _ranks(out, "kvq")):
        for case, arms in k.items():
            if case != "rank" and case != "coords":
                r[case]["on_ref_cache"] = arms
    return ref, ranks


class _StandIn:
    """A mesh shape for the specs (they read axis names and sizes only)."""

    def __init__(self, shape, axes=("data", "model")):
        self.shape = dict(zip(axes, shape))
        self.axis_names = tuple(axes)
        self.devices = np.arange(int(np.prod(shape))).reshape(shape)


def _rank_slice(tree, coords, mesh_shape=(2, 2)):
    """A whole serving state (numpy) cut to the state slice of the rank at
    ``coords`` = (data, model)."""
    ctx = tp.DistContext(mesh=_StandIn(mesh_shape))
    return to_numpy_tree(from_numpy_tree(tree, "cpu", tp.state_slices(
        tree, ctx, pos=coords[1], data_pos=coords[0])))


def _rows(coords):
    d = coords[0]
    return slice(d * B // 2, (d + 1) * B // 2)


def _hold_state(got, want, where: str) -> None:
    g = flatten_with_path(got)[0]
    w = flatten_with_path(want)[0]
    assert [keystr(p) for p, _ in g] == [keystr(p) for p, _ in w], where
    for (path, a), (_, b) in zip(g, w):
        k = f"{where} {keystr(path)}"
        assert a.shape == b.shape and a.dtype == b.dtype, k
        if a.dtype == np.int8:
            # quantize_kv's scale can sit one ulp off under the reference's
            # jit (XLA multiplies by 1/127): a value one count off there
            diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
            assert diff.max() <= 1, k
        elif np.issubdtype(a.dtype, np.integer):
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL,
                                       err_msg=k)


def _decode_logits(r, case, arm):
    """A rank's prefill and decode logits of ``arm`` (``"linear"`` or
    ``"ring"``): under ``kv_quant`` the decode steps' from the reference's
    own int8 cache (a value one count off moves a step's logits by up to
    3.5e-4 at the reduced width)."""
    own = r[case] if arm == "linear" else r[case]["ring"]
    if "on_ref_cache" not in r[case]:
        return own["logits"]
    return own["logits"][:1] + r[case]["on_ref_cache"][arm]


@pytest.mark.parametrize("case", NAMES)
def test_prefill_and_decode_logits_match_reference_mesh(runs, case):
    ref, ranks = runs
    want = ref[case]["logits"]
    for r in ranks:
        got = _decode_logits(r, case, "linear")
        assert len(got) == len(want) == N_NEW
        for step, (g, w) in enumerate(zip(got, want)):
            np.testing.assert_allclose(
                g, w[_rows(r["coords"])], rtol=RTOL, atol=ATOL,
                err_msg=f"rank {r['rank']} step {step}")
        # the forward went through the model line's collectives
        assert "reduce_from_model" in r[case]["stats"]


@pytest.mark.parametrize("case", NAMES)
def test_greedy_tokens_equal_reference_mesh_tokens(runs, case):
    """Every rank's ``Server.generate`` returns the whole batch's tokens,
    the reference's mesh tokens; the decode loop's own are its data
    shard's rows of them."""
    ref, ranks = runs
    want = ref[case]["tokens"]
    np.testing.assert_array_equal(ref[case]["server"], want)
    for r in ranks:
        np.testing.assert_array_equal(r[case]["server"], want)
        np.testing.assert_array_equal(r[case]["tokens"],
                                      want[_rows(r["coords"])])


@pytest.mark.parametrize("case", MOE)
def test_moe_mesh_tokens_are_the_data_shards(runs, case):
    """The MoE's capacity on the mesh is the data shard's: the reference's
    mesh tokens differ from its one-device tokens, and the port's are the
    mesh's."""
    ref, ranks = runs
    assert not np.array_equal(ref[case]["tokens"], ref[case]["one_device"])
    for r in ranks:
        np.testing.assert_array_equal(r[case]["server"], ref[case]["tokens"])


@pytest.mark.parametrize("case", NAMES)
def test_cache_slices_match_reference_shards(runs, case):
    ref, ranks = runs
    for r in ranks:
        for key in ("cache0", "cache"):
            _hold_state(r[case][key], _rank_slice(ref[case][key],
                                                  r["coords"]),
                        f"rank {r['rank']} {key}")


@pytest.mark.parametrize("case", RING)
def test_ring_cache_on_the_mesh(runs, case):
    """qwen2-1.5b's 80-token prompt in its 64-slot ring: the banded
    prefill and the ring decode over each rank's heads."""
    ref, ranks = runs
    want = ref[case]["ring"]
    assert want["cache"]["k"].shape[2] == _config(case).sliding_window
    for r in ranks:
        got = r[case]["ring"]
        for g, w in zip(_decode_logits(r, case, "ring"), want["logits"]):
            np.testing.assert_allclose(g, w[_rows(r["coords"])], rtol=RTOL,
                                       atol=ATOL)
        np.testing.assert_array_equal(got["tokens"],
                                      want["tokens"][_rows(r["coords"])])
        for key in ("cache0", "cache"):
            _hold_state(got[key], _rank_slice(want[key], r["coords"]),
                        f"rank {r['rank']} ring {key}")


@pytest.mark.parametrize("case", NAMES)
def test_sampled_tokens_agree_over_ranks(runs, case):
    """``temperature > 0`` with each rank's generator seeded differently:
    each model line's first rank draws and broadcasts, so every rank
    returns the same tokens."""
    ranks = runs[1]
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[case]["sampled"],
                                      ranks[0][case]["sampled"])


# ---------------------------------------------------------------------------
# in process
# ---------------------------------------------------------------------------

def _served(case: str):
    cfg = _config(case)
    k = NAMES.index(case)
    params = get_model(cfg).init_params(torch.Generator().manual_seed(k),
                                        cfg, device="cpu")
    S = next(c[3] for c in CASES if c[0] == case)
    rng = np.random.default_rng(k)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab, (B, S)).astype(np.int32))}
    if cfg.family == "vlm":
        batch["patches"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.n_patches, cfg.vit_dim)).astype(np.float32))
    if cfg.family == "audio":
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.enc_seq, cfg.d_model)).astype(np.float32))
    return cfg, params, batch


@pytest.mark.parametrize("case", NAMES)
def test_one_position_mesh_is_the_ctx_less_serve(case):
    """A ``(1, 1)`` mesh (no process group): the prefill's logits and
    cache, greedy and sampled tokens are the ctx-less calls' bit for
    bit."""
    cfg, params, batch = _served(case)
    ctx = tp.make_dist_ctx(make_host_mesh())
    ops = get_model(cfg)
    with torch.no_grad():
        l0, c0 = ops.prefill(params, batch, cfg)
        l1, c1 = ops.prefill(params, batch, cfg, ctx)
    assert torch.equal(l0, l1)
    for (p, a), (_, b) in zip(flatten_with_path(c0)[0],
                              flatten_with_path(c1)[0]):
        assert torch.equal(a, b), keystr(p)
    plain = Server(cfg, params, device="cpu")
    meshed = Server(cfg, params, device="cpu", ctx=ctx)
    assert torch.equal(plain.generate(batch, N_NEW),
                       meshed.generate(batch, N_NEW))
    assert torch.equal(
        plain.generate(batch, N_NEW, temperature=0.7,
                       generator=torch.Generator().manual_seed(3)),
        meshed.generate(batch, N_NEW, temperature=0.7,
                        generator=torch.Generator().manual_seed(3)))


def _want_cut(spec, shape, mesh_shape, coords) -> list:
    """The (dim, lo, hi) cuts a reference spec gives the rank at
    ``coords`` = (data, model) of a ``("data", "model")`` mesh."""
    sizes = dict(zip(("data", "model"), mesh_shape))
    out = []
    for dim, entry in enumerate(tuple(spec)):
        if entry is None:
            continue
        n = shape[dim] // sizes[entry]
        c = coords[0] if entry == "data" else coords[1]
        if sizes[entry] > 1:
            out.append((dim, c * n, (c + 1) * n))
    return out


@pytest.mark.parametrize("mesh_shape", ((2, 2), (4, 1)))
@pytest.mark.parametrize("case", NAMES)
def test_state_slices_follow_the_reference_specs(case, mesh_shape):
    """Each leaf of the family's whole serving state is cut as the
    reference's ``state_partition_specs`` place it on the mesh: the batch
    over ``data``, kv heads, SSD heads and conv channels over ``model``;
    ``kpos`` and ``pos`` whole. The port's ``init_cache`` with a rank's
    ctx has each slice's shape."""
    cfg = _config(case)
    ops = get_model(cfg)
    S = next(c[3] for c in CASES if c[0] == case)
    whole = ops.init_cache(cfg, B, S, device="cpu")
    mesh = _StandIn(mesh_shape)
    specs = dict((keystr(p), s) for p, s in flatten_with_path(
        jp.state_partition_specs(whole, jp.DistContext(mesh=mesh)))[0])
    ctx = tp.DistContext(mesh=mesh)
    n_cut = 0
    for d in range(mesh_shape[0]):
        for m in range(mesh_shape[1]):
            sl = tp.state_slices(whole, ctx, pos=m, data_pos=d)
            for (path, leaf), (_, s) in zip(flatten_with_path(whole)[0],
                                            flatten_with_path(sl)[0]):
                k = keystr(path)
                want = _want_cut(specs[k], leaf.shape, mesh_shape, (d, m))
                assert [tuple(c) for c in s] == want, k
                n_cut += bool(want)
            assert tp.batch_rows(B, ctx, d) == (d * B // mesh_shape[0],
                                                (d + 1) * B // mesh_shape[0])
    assert n_cut > 0
    if mesh_shape == (2, 2):
        # a rank's own init_cache has its slice's shapes
        from repro_torch.launch.mesh import Mesh

        class _Rank(Mesh):
            def coords(self, rank=None):
                return (1, 1)
        rank_ctx = tp.make_dist_ctx(_Rank(np.arange(4).reshape(2, 2),
                                          ("data", "model")))
        sl = tp.state_slices(whole, rank_ctx)
        want = [tuple(x.shape) for _, x in flatten_with_path(
            from_numpy_tree(to_numpy_tree(whole), "cpu", sl))[0]]
        got = flatten_with_path(ops.init_cache(cfg, B, S, device="cpu",
                                               ctx=rank_ctx))[0]
        assert [tuple(x.shape) for _, x in got] == want


def test_kv_heads_shared_by_ranks_serve():
    """qwen2-1.5b's 2 kv heads over 4 model positions (reduced: 4 query
    heads, one a position): each position holds the kv head its query
    head reads, positions 0-1 kv head 0 and 2-3 kv head 1 (the server,
    the cache, the state slices); the reference cuts ``head_dim`` there
    instead. ``tests/test_torch_mesh_kv_split.py`` serves it against the
    reference's mesh."""
    from repro_torch.launch.mesh import make_dry_mesh
    cfg = _config("qwen2")
    params = get_model(cfg).init_params(torch.Generator().manual_seed(0),
                                        cfg, device="cpu")
    whole = get_model(cfg).init_cache(cfg, B, 16, device="cpu")
    for pos in range(4):
        ctx = tp.make_dist_ctx(make_dry_mesh((1, 4), ("data", "model"),
                                             position=pos))
        Server(cfg, params, device="cpu", ctx=ctx)
        mine = get_model(cfg).init_cache(cfg, B, 16, device="cpu", ctx=ctx)
        assert mine["k"].shape[3] == 1
        sl = tp.state_slices(whole, ctx, heads=cfg.n_heads)
        assert tuple(sl["k"][-1]) == (3, pos // 2, pos // 2 + 1)
        with pytest.raises(ValueError, match="does not split over model=4"):
            tp.state_slices(whole, ctx)
    # the reference cuts head_dim there instead
    spec = jp.state_partition_specs(whole, jp.DistContext(mesh=_StandIn(
        (1, 4))))["k"]
    assert tuple(spec)[3:] == (None, "model")


def test_query_heads_that_do_not_split_raise():
    """4 query heads over 8 model positions: the reference cuts
    ``head_dim``, the port takes whole-head ranges (1, 0, 1, 0, ...: a
    position with no query heads holds no kv head and no cache columns;
    the server, the cache, the state slices). Heads whose ranges would
    cross kv groups unevenly (6 over 3 at 4: position 2's [3, 5)) still
    raise, naming the heads."""
    from repro_torch.launch.mesh import make_dry_mesh
    cfg = _config("qwen2")
    params = get_model(cfg).init_params(torch.Generator().manual_seed(0),
                                        cfg, device="cpu")
    whole = get_model(cfg).init_cache(cfg, B, 16, device="cpu")
    for pos in range(8):
        ctx = tp.make_dist_ctx(make_dry_mesh((1, 8), ("data", "model"),
                                             position=pos))
        Server(cfg, params, device="cpu", ctx=ctx)
        mine = get_model(cfg).init_cache(cfg, B, 16, device="cpu", ctx=ctx)
        n = 1 - pos % 2
        assert mine["k"].shape[3] == n
        sl = tp.state_slices(whole, ctx, heads=cfg.n_heads)
        assert tuple(sl["k"][-1])[2] - tuple(sl["k"][-1])[1] == n
    bad = dataclasses.replace(cfg, n_heads=6, n_kv_heads=3)
    ctx = tp.make_dist_ctx(make_dry_mesh((1, 4), ("data", "model")))
    with pytest.raises(ValueError, match="n_heads.*6"):
        Server(bad, params, device="cpu", ctx=ctx)
    with pytest.raises(ValueError, match="n_heads"):
        get_model(bad).init_cache(bad, B, 16, device="cpu", ctx=ctx)
    bad_cache = get_model(bad).init_cache(bad, B, 16, device="cpu")
    with pytest.raises(ValueError, match="do not split over model=4"):
        tp.state_slices(bad_cache, ctx, heads=bad.n_heads)


def test_batch_that_does_not_split_raises():
    """A batch of 3 over 2 data shards raises; with ``batch_shardable``
    False every rank serves the whole batch (``batch_partition_specs``
    then places it replicated)."""
    ctx = tp.DistContext(mesh=_StandIn((2, 2)))
    with pytest.raises(ValueError, match="does not split over 2 data"):
        tp.batch_rows(3, ctx, 0)
    whole = tp.DistContext(mesh=_StandIn((2, 2)), batch_shardable=False)
    assert tp.batch_rows(3, whole) == (0, 3)
