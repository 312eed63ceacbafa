"""The MoE (qwen3-moe-235b-a22b), interleaved MoE (llama4-maverick-400b-a17b)
and VLM (internvl2-76b) serve path, port against reference, on the reduced
configs: f32, 2 layers (llama4's one dense + MoE pair, top-1 of 4 experts
with a shared expert and ``d_ff_dense`` 512; qwen3-moe's top-2 of 4; the
VLM's 16 patches of 128).

Both packages get the reference's init params (``init_params`` on
``PRNGKey(0)``, carried with ``interop.from_numpy_tree``) and the same numpy
tokens and patches. On the CPU the port's prefill runs the plain chunked
attention. Checked:

- ``moe_block`` against the reference's: out rtol 1e-4, atol 1e-4 (f32; the
  two frameworks order their matmul sums differently); ``lb_loss`` and
  ``z_loss`` rtol 1e-5;
- over capacity with every gate 1.0 (top-1, all tokens on one expert): the
  same tokens kept (the lower index first, as ``jax.lax.top_k`` orders
  ties) and the rest dropped, equal to the reference within the tolerance
  above, the routed rows zero exactly where the reference's are;
- a decode step's MoE at capacity 1 (B = 4 tokens: the full configs' own
  capacity, and a reduced config made to give 1): against the reference;
- prefill logits and the cache (rtol 1e-4, atol 1e-4), the interleaved
  cache's order (layer 2 i is pair i's dense layer), the VLM's
  ``S + n_patches`` positions, three decode steps' logits;
- ``Server.generate``'s greedy tokens: equal;
- decode after a VLM prefill equals the longer prefill (rtol 2e-3, atol
  2e-3, as ``tests/test_models_smoke.py``'s teacher-forcing check): decode
  positions go on from ``S + n_patches``;
- a bf16 prefill, logits only, with the reference's ``silu`` (jax rounds
  its four steps to bf16, torch's ``F.silu`` once; the MoE's experts and
  the dense MLP end in it): atol 6e-2 against logits of up to about 4,
  as ``tests/test_torch_lm_serve.py`` holds the dense family;
- the per-pair ``stacked_layers`` of an interleaved model, and prefill on
  its per-layer (``split_layers``) tree equal to the stacked one;
- ``lm_batch``'s patches; the mesh branch raising naming ROADMAP item 38
  (the expert-parallel MoE; item 15, the mesh itself, is ported).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.data import lm_batch as j_lm_batch
from repro.models import get_model as j_get_model
from repro.models import layers as j_layers
from repro.models import transformer as j_transformer
from repro.sharding import single_device_ctx
from repro.training.serve import Server as JServer
from repro_torch.configs import get_config
from repro_torch.data.synthetic import lm_batch
from repro_torch.interop import from_numpy_tree
from repro_torch.models import get_model, layers, transformer
from repro_torch.training.serve import Server
from repro_torch.utils.tree import flatten_with_path, keystr, tree_leaves

ARCHS = ["qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b", "internvl2-76b"]
MOE_ARCHS = ARCHS[:2]
B, S = 2, 64
TOL = dict(rtol=1e-4, atol=1e-4)
CTX = single_device_ctx()


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().cpu().numpy(), np.asarray(want),
                               **(tol or TOL))


def _batch(cfg, batch, seq, seed):
    """numpy tokens (and a VLM's patches)."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (batch, seq)).astype(
        np.int32)}
    if cfg.family == "vlm":
        out["patches"] = rng.standard_normal(
            (batch, cfg.n_patches, cfg.vit_dim)).astype(np.float32)
    return out


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    name = request.param
    jcfg, cfg = j_get_config(name, reduced=True), get_config(name,
                                                             reduced=True)
    jparams = j_get_model(jcfg).init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, cfg, jparams, from_numpy_tree(_np(jparams), "cpu")


def _moe_params(jcfg, seed=0):
    """The reference's ``init_moe`` draw for ``jcfg`` (f32), as numpy."""
    return _np(j_layers.init_moe(jax.random.PRNGKey(seed), jcfg, jnp.float32))


def _x(cfg, shape, seed):
    return np.random.default_rng(seed).standard_normal(
        shape + (cfg.d_model,)).astype(np.float32)


def test_configs_take_the_transformer_path():
    for name in ARCHS:
        cfg = get_config(name, reduced=True)
        assert get_model(cfg).init_params is transformer.init_params
    assert transformer.interleaved(get_config(ARCHS[1]))
    assert not transformer.interleaved(get_config(ARCHS[0]))


def test_init_tree_matches_the_reference(models):
    """The port's own init has the reference's paths, shapes and dtypes
    (the router f32 in a bf16 model too), so the reference's tree crosses
    unchanged."""
    jcfg, cfg, jparams, params = models
    for dtype in ("float32", "bfloat16"):
        c = dataclasses.replace(cfg, dtype=dtype)
        jc = dataclasses.replace(jcfg, dtype=dtype)
        mine = get_model(c).init_params(torch.Generator().manual_seed(0), c,
                                        device="cpu")
        ref = from_numpy_tree(_np(j_get_model(jc).init_params(
            jax.random.PRNGKey(0), jc)), "cpu")
        got = [(k, tuple(v.shape), v.dtype)
               for k, v in flatten_with_path(mine)[0]]
        assert got == [(k, tuple(v.shape), v.dtype)
                       for k, v in flatten_with_path(ref)[0]]
        routers = [v.dtype for k, v in flatten_with_path(mine)[0]
                   if "router" in keystr(k)]
        assert routers == ([torch.float32] * len(routers))
        assert bool(routers) == bool(cfg.n_experts)


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_moe_block_matches_reference(name):
    jcfg, cfg = j_get_config(name, reduced=True), get_config(name,
                                                             reduced=True)
    p = _moe_params(jcfg)
    x = _x(cfg, (B, S), seed=3)
    jout, (jlb, jzl) = j_layers.moe_block(jnp.asarray(x),
                                          jax.tree_util.tree_map(
                                              jnp.asarray, p), jcfg, CTX)
    out, (lb, zl) = layers.moe_block(torch.from_numpy(x),
                                     from_numpy_tree(p, "cpu"), cfg)
    assert out.dtype == torch.float32 and out.shape == (B, S, cfg.d_model)
    _close(out, jout)
    _close(lb, jlb, rtol=1e-5)
    _close(zl, jzl, rtol=1e-5)


def test_over_capacity_ties_drop_the_same_tokens():
    """Top-1 gives every routed token the gate 1.0 exactly. With every
    token routed to expert 0 the expert keeps ``capacity`` of them: the
    first ones, as ``jax.lax.top_k`` orders ties, and drops the rest."""
    name = "llama4-maverick-400b-a17b"
    jcfg, cfg = j_get_config(name, reduced=True), get_config(name,
                                                             reduced=True)
    assert cfg.top_k == 1
    p = _moe_params(jcfg)
    x = _x(cfg, (1, 2 * S), seed=4)
    # a router whose expert-0 logit is x's sum times 10, x shifted so that
    # every token's sum is large: all tokens choose expert 0
    x = x + 1.0
    p["router"] = np.zeros_like(p["router"])
    p["router"][:, 0] = 10.0
    n = x.shape[1]
    cap = layers.moe_capacity(n, cfg)
    assert cap == 40 < n
    xt = x.reshape(n, cfg.d_model)
    args = (p["router"], p["w_gate_experts"], p["w_up_experts"],
            p["w_down_experts"])
    jout, _, _ = j_layers._moe_body(jnp.asarray(xt), *map(jnp.asarray, args),
                                    cfg=jcfg, E_local=jcfg.n_experts,
                                    e_offset=0, capacity=cap)
    out, _, _ = layers._moe_body(torch.from_numpy(xt),
                                 *(torch.from_numpy(np.array(a))
                                   for a in args), cfg=cfg, capacity=cap)
    jout = np.asarray(jout)
    kept = np.any(jout != 0, axis=1)
    np.testing.assert_array_equal(kept, np.arange(n) < cap)
    np.testing.assert_array_equal(out.numpy().any(axis=1), kept)
    _close(out, jout)


def test_decode_step_moe_at_capacity_one():
    """A decode step's MoE runs on B tokens: at B = 4 the full configs'
    capacity is 1 (each expert takes one token, tokens that share an expert
    are dropped). A reduced config with 16 experts gives the same."""
    assert layers.moe_capacity(4, get_config(MOE_ARCHS[0])) == 1
    assert layers.moe_capacity(4, get_config(MOE_ARCHS[1])) == 1
    for name in MOE_ARCHS:
        jcfg = dataclasses.replace(j_get_config(name, reduced=True),
                                   n_experts=16)
        cfg = dataclasses.replace(get_config(name, reduced=True),
                                  n_experts=16)
        assert layers.moe_capacity(4, cfg) == 1
        p = _moe_params(jcfg, seed=1)
        x = _x(cfg, (4, 1), seed=5)
        jout, (jlb, _) = j_layers.moe_block(
            jnp.asarray(x), jax.tree_util.tree_map(jnp.asarray, p), jcfg, CTX)
        out, (lb, _) = layers.moe_block(torch.from_numpy(x),
                                        from_numpy_tree(p, "cpu"), cfg)
        _close(out, jout)
        _close(lb, jlb, rtol=1e-5)


def test_moe_mesh_branch_names_item_15():
    """The mesh is ported (item 15) and so is its expert-parallel MoE
    branch: ``moe_block`` with the ctx of a one-position mesh (its
    ``model`` axis splits nothing) is the ctx-less call bit for bit, on
    the reference's draw (the many-rank branch is held in
    ``tests/test_torch_mesh_tp.py``)."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding.partition import make_dist_ctx
    cfg = get_config(MOE_ARCHS[0], reduced=True)
    p = from_numpy_tree(_moe_params(j_get_config(MOE_ARCHS[0], True)), "cpu")
    x = torch.from_numpy(_x(cfg, (1, 4), seed=5))
    o0, (lb0, zl0) = layers.moe_block(x, p, cfg)
    o1, (lb1, zl1) = layers.moe_block(x, p, cfg,
                                      make_dist_ctx(make_host_mesh()))
    assert torch.equal(o0, o1) and torch.equal(lb0, lb1) \
        and torch.equal(zl0, zl1)


def test_prefill_and_decode_match_reference(models):
    jcfg, cfg, jparams, params = models
    jops, ops = j_get_model(jcfg), get_model(cfg)
    batch = _batch(cfg, B, S, seed=1)
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (B, 3)).astype(
        np.int32)
    jlog, jcache = jops.prefill(jparams, _j(batch), jcfg, CTX)
    log, cache = ops.prefill(params, _t(batch), cfg)
    _close(log, jlog)
    S_all = S + (cfg.n_patches if cfg.family == "vlm" else 0)
    assert int(cache["pos"]) == int(jcache["pos"]) == S_all
    for key, want in _np(jcache).items():
        assert tuple(cache[key].shape) == want.shape, key
        _close(cache[key], want)
    assert cache["k"].shape[0] == cfg.n_layers
    for t in range(3):
        tok = toks[:, t:t + 1]
        jlog, jcache = jops.decode_step(jparams, jcache, jnp.asarray(tok),
                                        jcfg, CTX)
        log, cache = ops.decode_step(params, cache, torch.from_numpy(tok),
                                     cfg)
        _close(log, jlog)
    assert int(cache["pos"]) == S_all + 3


def test_interleaved_cache_stacks_dense_then_moe():
    """llama4's cache layer 2 i is pair i's dense layer, 2 i + 1 its MoE
    layer: layer 0's K is the dense layer's projection of the embedded
    prompt, and the layers run dense, then MoE."""
    name = "llama4-maverick-400b-a17b"
    cfg = get_config(name, reduced=True)
    params = get_model(cfg).init_params(torch.Generator().manual_seed(0),
                                        cfg, device="cpu")
    assert set(params["layers"]) == {"dense", "moe"}
    assert params["layers"]["dense"]["mlp"]["w_up"].shape == (
        1, cfg.d_model, cfg.d_ff_dense)
    assert [sorted(lp) for _, lp in transformer.layer_walk(params, cfg)] == [
        ["attn", "attn_norm", "mlp", "mlp_norm"],
        ["attn", "attn_norm", "mlp_norm", "moe"]]
    toks = torch.from_numpy(_batch(cfg, 1, 16, seed=6)["tokens"])
    _, cache = get_model(cfg).prefill(params, {"tokens": toks}, cfg)
    dense0 = layers.layer_params(params, 0)["dense"]
    x = layers.rms_norm(layers.embed_tokens(toks, params),
                        dense0["attn_norm"])
    _, k, _ = layers.qkv_project(x, dense0["attn"], cfg,
                                 torch.arange(16, dtype=torch.int32))
    torch.testing.assert_close(cache["k"][0, :, :16], k)


def test_greedy_generate_matches_reference(models):
    jcfg, cfg, jparams, params = models
    batch = _batch(cfg, B, S, seed=2)
    want = JServer(jcfg, CTX, jparams).generate(_j(batch), 6)
    got = Server(cfg, params, device="cpu").generate(_t(batch), 6)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_vlm_prefix_and_decode_positions():
    """The VLM's prompt is the projected patches, then the tokens: its
    cache holds S + n_patches positions, the reference's ``_embed_batch``
    gives the same embeddings, and a decode step after the prefill equals
    the prefill of one more token (positions go on from S + n_patches)."""
    name = "internvl2-76b"
    jcfg, cfg = j_get_config(name, reduced=True), get_config(name,
                                                             reduced=True)
    jparams = j_get_model(jcfg).init_params(jax.random.PRNGKey(0), jcfg)
    params = from_numpy_tree(_np(jparams), "cpu")
    batch = _batch(cfg, 1, 9, seed=7)
    short = {"tokens": batch["tokens"][:, :8], "patches": batch["patches"]}
    emb = transformer._embed_batch(params, _t(short), cfg)
    assert emb.shape == (1, cfg.n_patches + 8, cfg.d_model)
    _close(emb, j_transformer._embed_batch(jparams, _j(short), jcfg, CTX))
    ops = get_model(cfg)
    _, cache = ops.prefill(params, _t(short), cfg)
    S_all = cfg.n_patches + 8
    assert int(cache["pos"]) == S_all
    assert cache["kpos"][:S_all].tolist() == list(range(S_all))
    assert bool((cache["kpos"][S_all:] == -1).all())
    logits_d, _ = ops.decode_step(params, cache, torch.from_numpy(
        batch["tokens"][:, 8:9]), cfg)
    logits_f, _ = ops.prefill(params, _t(batch), cfg)
    torch.testing.assert_close(logits_d[:, -1], logits_f[:, -1], rtol=2e-3,
                               atol=2e-3)
    # without patches the prompt is the tokens alone
    _, cache = ops.prefill(params, {"tokens": torch.from_numpy(
        short["tokens"])}, cfg)
    assert int(cache["pos"]) == 8


@pytest.mark.parametrize("name", ARCHS)
def test_bf16_prefill_logits_match_reference(name, monkeypatch):
    jcfg = dataclasses.replace(j_get_config(name, reduced=True),
                               dtype="bfloat16")
    cfg = dataclasses.replace(get_config(name, reduced=True),
                              dtype="bfloat16")
    jparams = j_get_model(jcfg).init_params(jax.random.PRNGKey(0), jcfg)
    params = from_numpy_tree(_np(jparams), "cpu")
    assert {x.dtype for x in tree_leaves(params)} <= {torch.bfloat16,
                                                      torch.float32}
    batch = _batch(cfg, B, S, seed=4)
    jlog, _ = j_get_model(jcfg).prefill(jparams, _j(batch), jcfg, CTX)
    # the reference's silu: exp, add, divide and multiply each in bf16
    monkeypatch.setattr(torch.nn.functional, "silu",
                        lambda x: x * (1 / (1 + torch.exp(-x))))
    log, cache = get_model(cfg).prefill(params, _t(batch), cfg)
    assert log.dtype == torch.float32 and cache["k"].dtype == torch.bfloat16
    _close(log, jlog, rtol=0, atol=6e-2)


def test_interleaved_layers_split_per_pair():
    """An interleaved model's stacked subtree is its pairs: ``layer_params``
    and ``split_layers`` yield per-pair trees, and the prefill on the split
    tree equals the stacked one."""
    cfg = dataclasses.replace(get_config("llama4-maverick-400b-a17b",
                                         reduced=True), n_layers=4)
    ops = get_model(cfg)
    assert ops.stacked_layers == (("layers", 2),)
    assert get_model(get_config(MOE_ARCHS[0], reduced=True)
                     ).stacked_layers == (("layers", 2),)
    params = ops.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    split = layers.split_layers(params, ops.stacked_layers)
    assert len(split["layers"]) == 2 and set(split["layers"][1]) == {
        "dense", "moe"}
    toks = {"tokens": torch.from_numpy(_batch(cfg, 2, 16, seed=8)["tokens"])}
    a, ca = ops.prefill(params, toks, cfg)
    b, cb = ops.prefill(split, toks, cfg)
    assert torch.equal(a, b) and torch.equal(ca["k"], cb["k"])


def test_lm_batch_draws_patches():
    for dtype, tdt in (("float32", torch.float32),
                       ("bfloat16", torch.bfloat16)):
        cfg = dataclasses.replace(get_config("internvl2-76b", reduced=True),
                                  dtype=dtype)
        b = lm_batch(torch.Generator().manual_seed(0), cfg, 3, 8,
                     device="cpu")
        assert set(b) == {"tokens", "labels", "patches"}
        assert b["patches"].shape == (3, cfg.n_patches, cfg.vit_dim)
        assert b["patches"].dtype == tdt
        jb = j_lm_batch(jax.random.PRNGKey(0), dataclasses.replace(
            j_get_config("internvl2-76b", reduced=True), dtype=dtype), 3, 8)
        assert jb["patches"].shape == tuple(b["patches"].shape)
    cfg = get_config(MOE_ARCHS[0], reduced=True)
    assert set(lm_batch(torch.Generator().manual_seed(0), cfg, 1, 4,
                        device="cpu")) == {"tokens", "labels"}
