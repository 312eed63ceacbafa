"""Training the MoE (qwen3-moe-235b-a22b; llama4-maverick-400b-a17b, dense
and MoE layers interleaved) and VLM (internvl2-76b) families, port against
reference, on the CPU.

Both packages get the same inputs: the reference's init params
(``init_params`` on a ``PRNGKey``) carried with ``interop.from_numpy_tree``,
numpy tokens and patches, and ``ShardedLMDataset``'s batches, which both
draw from ``np.random.default_rng(seed)``. Reduced configs (f32, 2 layers:
qwen3-moe's top-2 of 4 experts, llama4's one dense + MoE pair at top-1
with a shared expert, internvl2's 16 patches of 128), batch 2 x 32, at
most 6 steps. Tolerances:

- ``train_loss`` against ``jax.value_and_grad`` of the reference's: the
  loss within rtol 1e-5 (an absolute floor of 1e-6 of its magnitude),
  each leaf's gradient within 1e-4 relative L2 (the two frameworks sum
  their f32 matmuls in other orders); the router losses alone likewise;
- remat on against off: bit for bit;
- the per-layer layout (``split_layers``: ``wo`` 2-D, the experts leaves
  of their own) against the stacked one, the gradients gathered back:
  bit for bit where one computation serves both layouts (every leaf of
  internvl2; ``wo`` is one matmul over the flattened heads either way),
  within 1e-6 relative L2 in f32 for the MoE models, whose experts run as
  batched matmuls stacked and as one matmul chain an expert split;
- the trainer against the reference's (the stacked partition): losses
  within rtol 1e-4 over 6 steps, ``saved_iter`` and the two-host loss's
  tier counts equal;
- the arena and PyTree paths: bit for bit, f32 and bf16 with 2
  microbatches (a mixed bf16/f32 arena: the router stays f32);
- the XOR parity of one full-width layer under ``FabricConfig()``, from
  shapes alone (meta tensors): internvl2 at most 7 GB and qwen3-moe at
  most 9 GB split, against at least 100 GB and 1 TB with the layers split
  alone.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core.policy import CheckpointPolicy as JPolicy
from repro.data.pipeline import ShardedLMDataset as JDataset
from repro.fabric import FabricConfig as JFabric
from repro.models import get_model as j_get_model
from repro.models import layers as j_layers
from repro.sharding import single_device_ctx
from repro.training import TrainLoop as JLoop
from repro.training import TrainLoopConfig as JLoopConfig
from repro_torch.configs import get_config
from repro_torch.core import arena as t_arena
from repro_torch.core.blocks import partition_pytree
from repro_torch.core.policy import CheckpointPolicy
from repro_torch.data import ShardedLMDataset
from repro_torch.fabric import CheckpointFabric, FabricConfig
from repro_torch.interop import from_numpy_tree
from repro_torch.models import get_model, transformer
from repro_torch.models import layers as t_layers
from repro_torch.training import (ArenaTrainState, TrainLoop,
                                  TrainLoopConfig, TrainState)
from repro_torch.training.step import loss_and_grad
from repro_torch.utils.tree import tree_leaves, tree_map

CTX = single_device_ctx()
ARCHS = ["qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b", "internvl2-76b"]
B, S = 2, 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while these tests run (several workers share a
    few cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, rtol=1e-5, floor=1e-6):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=floor * max(np.abs(want).max(), 1e-30))


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _cfgs(name, **over):
    """The reduced config of both packages, with the same overrides."""
    return (dataclasses.replace(j_get_config(name, reduced=True), **over),
            dataclasses.replace(get_config(name, reduced=True), **over))


def _ref_params(jcfg, seed=0):
    return _np(j_get_model(jcfg).init_params(jax.random.PRNGKey(seed), jcfg))


def _batch(cfg, seed=1):
    """numpy tokens, labels and a VLM's patches."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S + 1), dtype=np.int32)
    batch = {"tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy()}
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal(
            (B, cfg.n_patches, cfg.vit_dim)).astype(np.float32)
    return batch


def _against_reference(jcfg, cfg, params, batch):
    jv, jg = jax.value_and_grad(j_get_model(jcfg).train_loss)(
        jax.tree_util.tree_map(jnp.asarray, params),
        {k: jnp.asarray(v) for k, v in batch.items()}, jcfg, CTX)
    tv, tg = loss_and_grad(get_model(cfg), cfg,
                           from_numpy_tree(params, "cpu"),
                           from_numpy_tree(batch, "cpu"))
    _close(tv.item(), float(jv))
    leaves = tree_leaves(tg)
    assert len(leaves) == len(jax.tree_util.tree_leaves(jg))
    for t, j in zip(leaves, jax.tree_util.tree_leaves(jg)):
        assert t.shape == j.shape
        assert _rel_l2(t.numpy(), j) <= 1e-4
    return tg


# ---------------------------------------------------------------------------
# train_loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ARCHS)
def test_train_loss_and_grads_against_reference(name):
    jcfg, cfg = _cfgs(name)
    tg = _against_reference(jcfg, cfg, _ref_params(jcfg), _batch(cfg))
    assert all(torch.isfinite(g).all() for g in tree_leaves(tg))
    if cfg.n_experts:
        # the router and every expert get a gradient
        moe = tg["layers"]["moe"]
        moe = moe.get("moe", moe)       # an interleaved model's MoE layer
        assert float(moe["router"].abs().sum()) > 0
        for w in t_layers.EXPERT_KEYS:
            assert bool((moe[w].flatten(-2).abs().sum(-1) > 0).all())


def test_aux_losses_count_every_layer_of_an_interleaved_model(monkeypatch):
    """llama4 with two dense + MoE pairs: the router losses alone (the LM
    loss patched to 0 in both packages) equal the reference's, value and
    gradient, and are ``0.01 Σ lb / 4 + 0.001 Σ zl / 4`` over the two MoE
    layers: ``n_layers`` counts the dense layers too."""
    jcfg, cfg = _cfgs("llama4-maverick-400b-a17b", n_layers=4)
    params, batch = _ref_params(jcfg, seed=2), _batch(cfg, seed=3)
    monkeypatch.setattr(j_layers, "lm_loss_chunked",
                        lambda h, p, labels, mask, cfg, ctx: 0.0 * jnp.sum(h))
    monkeypatch.setattr(t_layers, "lm_loss_chunked",
                        lambda h, p, labels, mask, cfg: 0.0 * h.sum())
    _against_reference(jcfg, cfg, params, batch)
    calls = []
    moe_block = t_layers.moe_block

    def recording(x, p, c, **kw):
        out, aux = moe_block(x, p, c, **kw)
        calls.append([float(a) for a in aux])
        return out, aux

    monkeypatch.setattr(t_layers, "moe_block", recording)
    with torch.no_grad():
        aux = transformer.train_loss(from_numpy_tree(params, "cpu"),
                                     from_numpy_tree(batch, "cpu"), cfg)
    assert len(calls) == 2 and cfg.n_layers == 4
    lb, zl = (sum(c[i] for c in calls) for i in (0, 1))
    _close(aux.item(), 0.01 * lb / 4 + 0.001 * zl / 4)
    assert abs(aux.item() - (0.01 * lb / 2 + 0.001 * zl / 2)) \
        > 0.1 * aux.item()


def test_vlm_patch_prefix_takes_no_loss(monkeypatch):
    """internvl2: the stack runs ``n_patches + S`` positions, the LM loss
    sees the last S (the tokens) alone, and the projector gets a nonzero
    gradient (through the attention of the tokens to the prefix)."""
    jcfg, cfg = _cfgs("internvl2-76b")
    params = from_numpy_tree(_ref_params(jcfg), "cpu")
    batch = from_numpy_tree(_batch(cfg, seed=4), "cpu")
    seen = []
    lm_loss = t_layers.lm_loss_chunked

    def recording(h, *args):
        seen.append(h.detach().clone())
        return lm_loss(h, *args)

    monkeypatch.setattr(t_layers, "lm_loss_chunked", recording)
    with torch.no_grad():
        loss = transformer.train_loss(params, batch, cfg)
        h = transformer._embed_batch(params, batch, cfg)
        assert h.shape[1] == cfg.n_patches + S
        pos = torch.arange(h.shape[1], dtype=torch.int32)
        h, _, _ = transformer._stack_fwd(h, params, cfg, pos, window=0,
                                         q_chunk=cfg.attn_chunk,
                                         kv_chunk=cfg.attn_chunk)
    assert seen[0].shape == (B, S, cfg.d_model)
    assert torch.equal(seen[0], h[:, cfg.n_patches:])
    mask = torch.ones((B, S))
    assert torch.equal(loss, lm_loss(h[:, cfg.n_patches:], params,
                                     batch["labels"], mask, cfg))
    monkeypatch.setattr(t_layers, "lm_loss_chunked", lm_loss)
    _, g = loss_and_grad(get_model(cfg), cfg, params, batch)
    proj = g["projector"]["proj"]
    assert torch.isfinite(proj).all() and float(proj.abs().sum()) > 0


@pytest.mark.parametrize("name", ARCHS)
def test_remat_is_bit_exact(name):
    jcfg, cfg = _cfgs(name)
    params, batch = _ref_params(jcfg, seed=3), _batch(cfg, seed=2)
    out = []
    for remat in (True, False):
        c = dataclasses.replace(cfg, remat=remat)
        out.append(loss_and_grad(get_model(c), c,
                                 from_numpy_tree(params, "cpu"),
                                 from_numpy_tree(batch, "cpu")))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(out[0][1]),
                                                 tree_leaves(out[1][1])))


# ---------------------------------------------------------------------------
# the per-layer layout
# ---------------------------------------------------------------------------

def _restacked(node):
    """A per-layer layer tree in the stacked layout's leaf shapes: ``wo``
    back to ``(Hq, Dh, D)`` (from the first dim of ``wq``'s heads), the
    2-D expert leaves to ``(E, ., .)`` (from the router's E)."""
    if isinstance(node, dict):
        out = {k: _restacked(v) for k, v in node.items()}
        if "wo" in out and out["wo"].dim() == 2:
            hq, dh = out["wq"].shape[1:]
            out["wo"] = out["wo"].reshape(hq, dh, -1)
        if "router" in out:
            e = out["router"].shape[-1]
            for w in t_layers.EXPERT_KEYS:
                out[w] = out[w].reshape(e, -1, out[w].shape[-1])
        return out
    return node


@pytest.mark.parametrize("name", ARCHS)
def test_split_layout_matches_the_stacked_one(name):
    jcfg, cfg = _cfgs(name)
    ops = get_model(cfg)
    stacked = from_numpy_tree(_ref_params(jcfg, seed=4), "cpu")
    batch = from_numpy_tree(_batch(cfg, seed=5), "cpu")
    split = t_layers.split_layers(stacked, ops.stacked_layers)
    (key, n), = ops.stacked_layers
    assert isinstance(split[key], list) and len(split[key]) == n
    for k in set(stacked) - {key}:
        assert split[k] is stacked[k]
    for lp in split[key]:
        for sub in (lp["dense"], lp["moe"]) if "dense" in lp else (lp,):
            assert sub["attn"]["wo"].shape == (cfg.n_heads * cfg.head_dim,
                                               cfg.d_model)
            if "moe" in sub:
                e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
                for w, shape in zip(t_layers.EXPERT_KEYS,
                                    ((e * d, f), (e * d, f), (e * f, d))):
                    x = sub["moe"][w]
                    assert x.shape == shape and x.is_contiguous()
    l0, g0 = loss_and_grad(ops, cfg, stacked, batch)
    l1, g1 = loss_and_grad(ops, cfg, split, batch)
    back = tree_map(lambda *xs: torch.stack(xs),
                    *[_restacked(lp) for lp in g1[key]])
    pairs = list(zip(tree_leaves(g0), tree_leaves({**g1, key: back})))
    assert len(pairs) == len(tree_leaves(g0))
    # both layouts run the same batched matmuls on views of one layout
    assert torch.equal(l0, l1)
    assert all(a.shape == b.shape and torch.equal(a, b) for a, b in pairs)


def test_full_width_layer_parity_from_shapes(monkeypatch):
    """One full-width layer (bf16, its embedding, untied head and
    projector) partitioned in 128-row blocks under ``FabricConfig()``,
    from meta tensors: the per-layer layout's XOR parity is at most 7 GB
    for internvl2 (``wo`` 2-D) and 9 GB for qwen3-moe (the expert stacks
    2-D, blocks of one expert's rows); with the layers split alone, ``wo`` and the expert
    stacks are one block each and it is at least 100 GB and 1 TB."""
    monkeypatch.setattr(
        t_layers, "dense_init",
        lambda gen, shape, fan_in=None, dtype=torch.float32, device=None:
        torch.empty(tuple(shape), dtype=dtype, device="meta"))
    for name, split_max, layers_min in (("internvl2-76b", 7e9, 100e9),
                                        ("qwen3-moe-235b-a22b", 9e9, 1e12)):
        cfg = dataclasses.replace(get_config(name), n_layers=1)
        ops = get_model(cfg)
        params = ops.init_params(torch.Generator(), cfg, device="meta")
        layers_only = {**params, "layers": t_layers.unstack_layers(
            params["layers"], 1)}
        split = t_layers.split_layers(params, ops.stacked_layers)
        got = {}
        for form, tree in (("split", split), ("layers", layers_only)):
            assert all(x.device.type == "meta" for x in tree_leaves(tree))
            codec = CheckpointFabric(partition_pytree(tree, 128),
                                     FabricConfig()).parity
            got[form] = codec.n_groups * codec.layout.frame_elems * 4
        assert got["split"] <= split_max < layers_min <= got["layers"], \
            (name, got)


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ARCHS)
def test_trainer_against_reference(name):
    """Losses over 6 steps within rtol 1e-4; hosts 0 and 2 lost together
    at step 5 recover with the reference's tier counts (PARITY among
    them), and ``saved_iter`` is equal."""
    sched = [(5, "host", 0), (5, "host", 2)]
    jcfg, cfg = _cfgs(name)
    jl = JLoop(jcfg, CTX, loop_cfg=JLoopConfig(
        policy=JPolicy.scar(fraction=0.25, interval=2), fabric=JFabric(),
        fail_schedule=sched))
    js = jl.init_state()
    params = _np(js.params)
    jl.run(js, iter(JDataset(jcfg, B, S, CTX)), 6)
    tl = TrainLoop(cfg, loop_cfg=TrainLoopConfig(
        policy=CheckpointPolicy.scar(fraction=0.25, interval=2),
        fabric=FabricConfig(), fail_schedule=sched,
        per_layer_leaves=False), device="cpu")
    ts = tl.init_state(params=params)
    assert isinstance(ts, ArenaTrainState)
    tl.run(ts, iter(ShardedLMDataset(cfg, B, S, device="cpu")), 6)
    np.testing.assert_allclose([m["loss"] for m in tl.metrics],
                               [m["loss"] for m in jl.metrics], rtol=1e-4)
    assert tl.controller.ckpt.saved_iter.tolist() \
        == np.asarray(jl.controller.ckpt.saved_iter).tolist()
    jf = jl.metrics[4]["failures"][0]
    tf = tl.metrics[4]["failures"][0]
    assert tf["tier_counts"] == jf["tier_counts"]
    assert tf["lost_blocks"] == jf["lost_blocks"] > 0
    assert tf["tier_counts"]["PARITY"] > 0
    assert tf["tier_sq"]["PEER_REPLICA"] == tf["tier_sq"]["PARITY"] == 0.0


def _loop(cfg, arena_state):
    loop = TrainLoop(cfg, loop_cfg=TrainLoopConfig(
        policy=CheckpointPolicy.scar(fraction=0.25, interval=2),
        fabric=FabricConfig(), arena_state=arena_state), device="cpu")
    return loop, loop.init_state(), ShardedLMDataset(cfg, B, S,
                                                      device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ARCHS)
def test_arena_and_pytree_paths_bit_identical(name, dtype):
    """The per-layer layout (the trainer's default), 4 steps each way; in
    bf16 with 2 microbatches the router stays f32, so an MoE model's
    arena mixes bf16 and f32 runs, and its value domain round-trips bit
    for bit."""
    over = {"dtype": dtype, "microbatch": 2} if dtype == "bfloat16" else {}
    cfg = dataclasses.replace(get_config(name, reduced=True), **over)
    la, sa, da = _loop(cfg, True)
    lt, st, dt = _loop(cfg, False)
    assert isinstance(sa, ArenaTrainState) and isinstance(st, TrainState)
    lay = la.arena_layout
    if dtype == "bfloat16":
        runs = {r[4] for r in lay.value_runs()}
        assert runs == ({torch.bfloat16, torch.float32} if cfg.n_experts
                        else {torch.bfloat16})
        assert not lay.uniform_f32
        vals = t_arena.decode_values(sa.arena, lay)
        assert torch.equal(vals.view(torch.int32), t_arena.pack_values(
            t_arena.unpack_arena(sa.arena, lay), lay).view(torch.int32))
        assert torch.equal(t_arena.encode_values(vals, lay), sa.arena)
    sa = la.run(sa, iter(da), 4)
    st = lt.run(st, iter(dt), 4)
    assert [m["loss"] for m in la.metrics] == [m["loss"] for m in lt.metrics]
    assert all(np.isfinite(m["loss"]) for m in la.metrics)
    assert torch.equal(la.controller._ckpt_arena, lt.controller._ckpt_arena)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(sa.params),
                                                 tree_leaves(st.params)))


def test_arena_recovery_writes_the_live_arena_in_place():
    """A two-host loss on the arena path: the recovered words go back into
    the live arena in place (the state keeps its one arena), no decoded
    tree of the checkpoint stays alive after it, and the run's losses and
    tier counts equal the PyTree path's."""
    cfg = get_config("internvl2-76b", reduced=True)
    sched = [(5, "host", 0), (5, "host", 2)]
    runs = []
    for arena_state in (True, False):
        loop = TrainLoop(cfg, loop_cfg=TrainLoopConfig(
            policy=CheckpointPolicy.scar(fraction=0.25, interval=2),
            fabric=FabricConfig(), arena_state=arena_state,
            fail_schedule=sched), device="cpu")
        state = loop.init_state()
        before = state.arena if arena_state else None
        state = loop.run(state, iter(ShardedLMDataset(cfg, B, S,
                                                      device="cpu")), 6)
        if arena_state:
            assert state.arena is before
            assert loop.controller._ckpt.values is None
        runs.append(([m["loss"] for m in loop.metrics],
                     loop.metrics[4]["failures"][0]["tier_counts"]))
    tiers = runs[0][1]
    assert runs[0] == runs[1] and tiers["PEER_REPLICA"] > 0
    assert tiers["RUNNING_CKPT"] > 0
