"""The LM serve path, port against reference, on the reduced mamba2-370m
(SSM) and qwen2-1.5b (dense) configs.

Both packages get the reference's init params (``init_params`` on
``PRNGKey(0)``) and the same numpy tokens; the params cross with
``interop.from_numpy_tree``. On the CPU the port's prefill runs the plain
versions of its kernels (the ``ssd_intra`` plain version inside
``ssd_chunked_kernel``, the chunked ``flash_attention``). Checked:

- prefill logits and the cache or state: rtol 1e-4, atol 1e-4 (f32; the
  two frameworks order their matmul sums differently);
- three decode steps' logits, the same tolerance;
- ``Server.generate``'s greedy tokens: equal;
- the ring prefill at S = 96, longer than the reduced window of 64, with
  ``cache_spec(use_window=True)``, and a decode step after it;
- decode equals prefill within the port (``tests/test_models_smoke.py``'s
  two teacher-forcing checks): rtol 2e-3, atol 2e-3, as there;
- one bf16 reduced case per model, prefill logits only: atol 6e-2 against
  logits of up to about 4 (bf16 keeps 8 bits of mantissa; XLA and torch
  round the bf16 matmul outputs and the conv's partial sums at other
  places; the gaps measured on this test's inputs are 0.054 for
  mamba2-370m and 0.031 for qwen2-1.5b);
- ``examples/serve_with_recovery.py``'s flow in the port on the reduced
  mamba2-370m: checkpoint, a 30% loss, partial restore, identical tokens.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import list_configs as j_list_configs
from repro.models.api import serve_cache_len as j_serve_cache_len
from repro.models import get_model as j_get_model
from repro.models import transformer as j_transformer
from repro.sharding import single_device_ctx
from repro.training.serve import Server as JServer
from repro_torch.configs import get_config, list_configs
from repro_torch.core.controller import FTController
from repro_torch.core.policy import CheckpointPolicy
from repro_torch.interop import from_numpy_tree
from repro_torch.models import get_model
from repro_torch.models import transformer
from repro_torch.models.api import serve_cache_len
from repro_torch.training.serve import Server
from repro_torch.utils.tree import tree_leaves

ARCHS = ["mamba2-370m", "qwen2-1.5b"]
B, S = 2, 64
TOL = dict(rtol=1e-4, atol=1e-4)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, shape).astype(np.int32)


@pytest.fixture(scope="module")
def ctx():
    return single_device_ctx()


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    name = request.param
    jcfg = j_get_config(name, reduced=True)
    cfg = get_config(name, reduced=True)
    jparams = j_get_model(jcfg).init_params(jax.random.PRNGKey(0), jcfg)
    params = from_numpy_tree(_np(jparams), "cpu")
    return jcfg, cfg, jparams, params


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().cpu().numpy(), np.asarray(want),
                               **(tol or TOL))


def test_configs_are_the_reference_copies():
    assert list_configs() == j_list_configs()
    for name in list_configs():
        for reduced in (False, True):
            cfg, jcfg = get_config(name, reduced), j_get_config(name, reduced)
            assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
            for seq in (64, 4096, 4097, 524288):
                assert serve_cache_len(cfg, seq) == \
                    j_serve_cache_len(jcfg, seq)


def test_prefill_and_decode_match_reference(models, ctx):
    jcfg, cfg, jparams, params = models
    jops, ops = j_get_model(jcfg), get_model(cfg)
    toks = _tokens(cfg, (B, S + 3))
    jlog, jstate = jops.prefill(jparams, {"tokens": jnp.asarray(toks[:, :S])},
                                jcfg, ctx)
    log, state = ops.prefill(params, {"tokens": torch.from_numpy(
        toks[:, :S])}, cfg)
    _close(log, jlog)
    jstate_np = _np(jstate)
    assert set(state) == set(jstate_np)
    for key, want in jstate_np.items():
        assert tuple(state[key].shape) == want.shape, key
        assert str(state[key].dtype).removeprefix("torch.") == \
            want.dtype.name, key
        _close(state[key], want)
    for t in range(S, S + 3):
        tok = toks[:, t:t + 1]
        jlog, jstate = jops.decode_step(jparams, jstate, jnp.asarray(tok),
                                        jcfg, ctx)
        log, state = ops.decode_step(params, state, torch.from_numpy(tok),
                                     cfg)
        _close(log, jlog)
    assert int(state["pos"]) == S + 3


def test_greedy_generate_matches_reference(models, ctx):
    jcfg, cfg, jparams, params = models
    toks = _tokens(cfg, (B, S), seed=2)
    want = JServer(jcfg, ctx, jparams).generate(
        {"tokens": jnp.asarray(toks)}, 6)
    got = Server(cfg, params, device="cpu").generate(
        {"tokens": torch.from_numpy(toks)}, 6)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_ring_prefill_matches_reference(ctx):
    jcfg = j_get_config("qwen2-1.5b", reduced=True)
    cfg = get_config("qwen2-1.5b", reduced=True)
    jparams = j_get_model(jcfg).init_params(jax.random.PRNGKey(0), jcfg)
    params = from_numpy_tree(_np(jparams), "cpu")
    S_ring = 96
    assert S_ring > cfg.sliding_window == 64
    toks = _tokens(cfg, (1, S_ring + 1), seed=3)
    jspec = j_transformer.cache_spec(jcfg, S_ring, use_window=True)
    spec = transformer.cache_spec(cfg, S_ring, use_window=True)
    assert spec.ring and spec.cache_len == jspec.cache_len == 64
    jlog, jcache = j_transformer.prefill(
        jparams, {"tokens": jnp.asarray(toks[:, :S_ring])}, jcfg, ctx, jspec)
    log, cache = transformer.prefill(
        params, {"tokens": torch.from_numpy(toks[:, :S_ring])}, cfg, spec)
    _close(log, jlog)
    for key, want in _np(jcache).items():
        _close(cache[key], want)
    # one decode step on the ring, through the API's geometry inference
    tok = toks[:, S_ring:]
    jlog, _ = j_get_model(jcfg).decode_step(jparams, jcache,
                                            jnp.asarray(tok), jcfg, ctx)
    log, cache = get_model(cfg).decode_step(params, cache,
                                            torch.from_numpy(tok), cfg)
    _close(log, jlog)


def test_decode_matches_prefill_dense():
    cfg = get_config("yi-9b", reduced=True)
    ops = get_model(cfg)
    params = ops.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    toks = torch.randint(0, cfg.vocab, (1, 9),
                         generator=torch.Generator().manual_seed(2))
    _, cache = ops.prefill(params, {"tokens": toks[:, :8]}, cfg)
    logits_d, _ = ops.decode_step(params, cache, toks[:, 8:9], cfg)
    logits_f, _ = ops.prefill(params, {"tokens": toks}, cfg)
    torch.testing.assert_close(logits_d[:, -1], logits_f[:, -1], rtol=2e-3,
                               atol=2e-3)


def test_decode_matches_prefill_ssm():
    cfg = get_config("mamba2-370m", reduced=True)
    ops = get_model(cfg)
    params = ops.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    Sq = cfg.ssm_chunk * 2
    toks = torch.randint(0, cfg.vocab, (1, Sq + 1),
                         generator=torch.Generator().manual_seed(2))
    _, state = ops.prefill(params, {"tokens": toks[:, :Sq]}, cfg)
    logits_d, _ = ops.decode_step(params, state, toks[:, Sq:], cfg)
    state2 = ops.init_cache(cfg, 1, Sq, device="cpu")
    for t in range(Sq + 1):
        logits_s, state2 = ops.decode_step(params, state2,
                                           toks[:, t:t + 1], cfg)
    torch.testing.assert_close(logits_d[:, -1], logits_s[:, -1], rtol=2e-3,
                               atol=2e-3)


@pytest.mark.parametrize("name", ARCHS)
def test_bf16_prefill_logits_match_reference(name, ctx):
    jcfg = dataclasses.replace(j_get_config(name, reduced=True),
                               dtype="bfloat16")
    cfg = dataclasses.replace(get_config(name, reduced=True),
                              dtype="bfloat16")
    jparams = j_get_model(jcfg).init_params(jax.random.PRNGKey(0), jcfg)
    params = from_numpy_tree(_np(jparams), "cpu")
    assert all(x.dtype in (torch.bfloat16, torch.float32)
               for x in tree_leaves(params))
    toks = _tokens(cfg, (B, S), seed=4)
    jlog, _ = j_get_model(jcfg).prefill(jparams, {"tokens": jnp.asarray(toks)},
                                        jcfg, ctx)
    log, _ = get_model(cfg).prefill(params, {"tokens": torch.from_numpy(toks)},
                                    cfg)
    assert log.dtype == torch.float32
    _close(log, jlog, rtol=0, atol=6e-2)


def test_serve_with_recovery_flow():
    """examples/serve_with_recovery.py in the port: a lossless partial
    restore from a fresh running checkpoint gives identical tokens."""
    cfg = get_config("mamba2-370m", reduced=True)
    params = get_model(cfg).init_params(torch.Generator().manual_seed(0),
                                        cfg, device="cpu")
    batch = {"tokens": torch.from_numpy(_tokens(cfg, (4, 32), seed=5))}
    toks0 = Server(cfg, params, device="cpu").generate(batch, 8)
    ctl = FTController(params, CheckpointPolicy.scar(fraction=1.0,
                                                     interval=1),
                       device="cpu")
    ctl.checkpoint_now(1, params)
    lost = ctl.sample_failure(0.3)
    assert 0 < int(lost.sum()) < ctl.partition.total_blocks
    recovered, info = ctl.on_failure(params, lost)
    assert info["lost_blocks"] == int(lost.sum())
    assert info["applied_sq"] == 0.0
    toks1 = Server(cfg, recovered, device="cpu").generate(batch, 8)
    assert torch.equal(toks0, toks1)


def test_unported_families_name_their_roadmap_items():
    """Every family serves (the MoE and VLM ones since ROADMAP item 19)
    and trains (the MoE and VLM ones since item 31: a finite loss, a
    trainer on the CPU); the dense, MoE and VLM families build and serve
    with each perf variant (item 20): the int8 KV cache and the triangle
    prefill."""
    from repro_torch.training.train_loop import TrainLoop
    for name in ("qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b",
                 "internvl2-76b"):
        cfg = get_config(name, reduced=True)
        ops = get_model(cfg)
        assert ops.supports_long_context
        params = ops.init_params(torch.Generator().manual_seed(0), cfg,
                                 device="cpu")
        batch = {"tokens": torch.from_numpy(_tokens(cfg, (1, 8), seed=6))}
        if cfg.family == "vlm":
            batch["patches"] = torch.zeros((1, cfg.n_patches, cfg.vit_dim))
        toks = Server(cfg, params, device="cpu").generate(batch, 3)
        assert toks.shape == (1, 3)
        loss = ops.train_loss(params, dict(batch, labels=batch["tokens"]),
                              cfg)
        assert loss.shape == () and torch.isfinite(loss)
        assert TrainLoop(cfg, device="cpu").device.type == "cpu"
    # the hybrid and encoder-decoder families (item 18) are ported
    for name, long_context in (("zamba2-1.2b", True),
                               ("whisper-medium", False)):
        ops = get_model(get_config(name, reduced=True))
        assert ops.supports_long_context is long_context
    for name in ("yi-9b", "qwen3-moe-235b-a22b", "internvl2-76b"):
        for option in ("kv_quant", "triangle_prefill"):
            cfg = dataclasses.replace(get_config(name, reduced=True),
                                      **{option: True})
            ops = get_model(cfg)
            params = ops.init_params(torch.Generator().manual_seed(0), cfg,
                                     device="cpu")
            batch = {"tokens": torch.from_numpy(_tokens(cfg, (1, 8),
                                                        seed=7))}
            if cfg.family == "vlm":
                batch["patches"] = torch.zeros((1, cfg.n_patches,
                                                cfg.vit_dim))
            _, cache = ops.prefill(params, batch, cfg)
            assert (cache["k"].dtype == torch.int8) is (option == "kv_quant")
            assert ("k_scale" in cache) is (option == "kv_quant")
            toks = Server(cfg, params, device="cpu").generate(batch, 3)
            assert toks.shape == (1, 3)
    # the LM training loss (item 10) is ported: it runs on the dense
    # family's reduced yi-9b and gives a finite scalar
    cfg = get_config("yi-9b", reduced=True)
    ops = get_model(cfg)
    params = ops.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    toks = torch.randint(0, cfg.vocab, (2, 17),
                         generator=torch.Generator().manual_seed(1))
    loss = ops.train_loss(params, {"tokens": toks[:, :-1],
                                   "labels": toks[:, 1:]}, cfg)
    assert loss.shape == () and torch.isfinite(loss)
