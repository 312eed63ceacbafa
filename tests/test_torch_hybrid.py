"""The hybrid family (``models/hybrid.py``, zamba2-1.2b), port against
reference, on the reduced config.

Both packages get the reference's init params (``init_params`` on
``PRNGKey(0)``, carried with ``interop.from_numpy_tree``) and the same
numpy tokens. On the CPU the port's prefill runs the plain versions of its
kernels (the ``ssd_intra`` plain version inside the SSD scan, the chunked
``flash_attention`` for the shared block). The reduced config has 2
layers and ``attn_every`` 2, one segment; ``n_layers=5`` gives segments of
2, 2 and 1. Checked:

- prefill logits and every state entry: rtol 1e-4, atol 1e-4 (f32). At
  5 layers the logits and every state entry but two keep that tolerance
  (the logits' gap 2.8e-5). The two are the shared block's K and V caches
  of its third application (``k[2]``, ``v[2]``), held within 1e-4 of
  their own scale, |got - want| <= 1e-4 |want| + 1e-4 max|want|, the
  check ``chip_smoke.py`` applies to the kernels: random weights amplify
  the rounding 2-3x a Mamba2 layer (each layer, fed the same input in
  both packages, adds at most 1.7e-5 to a residual stream of magnitude
  30; fed its own, the gap grows 1.7e-5, 4.3e-5, 1.2e-4, 2.2e-4, 3.9e-4
  over the five), so ``k[2]`` reaches 1.5e-4 on values of 4.6 and
  ``v[2]`` 1.7e-4 on values of 4.1;
- three decode steps' logits at the same tolerance, and decoding past the
  64 empty slots, where both packages wrap the cache;
- ``Server.generate``'s greedy tokens: equal;
- ``train_loss``: rtol 1e-4;
- one bf16 prefill, logits only, twice. The cause of the gap is
  ``silu``: the reference's (jax's ``x * (1 / (1 + exp(-x)))``) rounds
  each of its four steps to bf16, torch's ``F.silu`` rounds once. Fed
  the same input, a Mamba2 layer (whose conv and gate end in ``silu``)
  then differs by one bf16 ulp of its output in 40% of the elements, and
  the logits stage by none. So the port run with the reference's
  ``silu`` is held at atol 6e-2, as ``test_torch_lm_serve.py`` holds
  reduced mamba2-370m (gap 0.0099 on this test's tokens, 0.010-0.032
  over token seeds 0-5). The port as it ships is held at atol 1e-1: its
  gap is 0.0667 here and 0.038-0.078 over seeds 0-5, where reduced
  mamba2-370m's is 0.033-0.060;
- ``examples/serve_with_recovery.py``'s flow: identical tokens after a
  lossless partial restore;
- a prompt that is not a multiple of ``ssm_chunk`` raises;
- ``interop.from_numpy_tree`` carries the reference's f32 and bf16 trees
  unchanged.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import get_model as j_get_model
from repro.models import hybrid as j_hybrid
from repro.sharding import single_device_ctx
from repro.training.serve import Server as JServer
from repro_torch.configs import get_config
from repro_torch.core.controller import FTController
from repro_torch.core.policy import CheckpointPolicy
from repro_torch.interop import from_numpy_tree
from repro_torch.models import get_model, hybrid
from repro_torch.training.serve import Server
from repro_torch.utils.tree import tree_flatten

NAME = "zamba2-1.2b"
B, S = 2, 64
TOL = dict(rtol=1e-4, atol=1e-4)
CTX = single_device_ctx()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while these tests run: the suite runs several
    workers on a few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, shape).astype(np.int32)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().cpu().numpy(), np.asarray(want),
                               **(tol or TOL))


def _configs(**kw):
    return (dataclasses.replace(j_get_config(NAME, reduced=True), **kw),
            dataclasses.replace(get_config(NAME, reduced=True), **kw))


@pytest.fixture(scope="module", params=[2, 5], ids=["one_segment",
                                                    "ragged_segments"])
def models(request):
    jcfg, cfg = _configs(n_layers=request.param)
    jparams = j_get_model(jcfg).init_params(jax.random.PRNGKey(0), jcfg)
    params = from_numpy_tree(_np(jparams), "cpu")
    return jcfg, cfg, jparams, params


def _close_state(state, jstate):
    """Every state entry of the port's ``state`` within TOL of the
    reference's ``jstate`` (numpy), but for the shared block's K and V
    caches of its third application on, held within 1e-4 of their own
    scale (see the module docstring)."""
    got_leaves, _ = tree_flatten(state)
    paths = jax.tree_util.tree_flatten_with_path(jstate)[0]
    assert len(got_leaves) == len(paths)
    for got, (path, want) in zip(got_leaves, paths):
        assert tuple(got.shape) == want.shape
        assert str(got.dtype).removeprefix("torch.") == want.dtype.name
        if path[0].key not in ("k", "v"):
            _close(got, want)
            continue
        _close(got[:2], want[:2])
        rest = want[2:]
        lim = 1e-4 * (np.abs(rest) + np.abs(rest).max(initial=0.0))
        assert np.all(np.abs(got[2:].numpy() - rest) <= lim)


def test_segments_match_reference():
    for n_layers, want in ((2, [(0, 2)]), (5, [(0, 2), (2, 2), (4, 1)])):
        jcfg, cfg = _configs(n_layers=n_layers)
        assert hybrid._segments(cfg) == j_hybrid._segments(jcfg) == want
        assert hybrid.n_segments(cfg) == j_hybrid.n_segments(jcfg) \
            == len(want)
    full = get_config(NAME)
    assert hybrid._segments(full) == j_hybrid._segments(j_get_config(NAME))
    assert [n for _, n in hybrid._segments(full)] == [6] * 6 + [2]


def test_prefill_and_decode_match_reference(models):
    jcfg, cfg, jparams, params = models
    jops, ops = j_get_model(jcfg), get_model(cfg)
    toks = _tokens(cfg, (B, S + 3))
    jlog, jstate = jops.prefill(jparams, {"tokens": jnp.asarray(toks[:, :S])},
                                jcfg, CTX)
    log, state = ops.prefill(params, {"tokens": torch.from_numpy(
        toks[:, :S])}, cfg)
    _close(log, jlog)
    jstate_np = _np(jstate)
    assert set(state) == set(jstate_np) and set(state["ssm"]) == \
        set(jstate_np["ssm"])
    _close_state(state, jstate_np)
    assert state["k"].shape[0] == hybrid.n_segments(cfg)
    for t in range(S, S + 3):
        tok = toks[:, t:t + 1]
        jlog, jstate = jops.decode_step(jparams, jstate, jnp.asarray(tok),
                                        jcfg, CTX)
        log, state = ops.decode_step(params, state, torch.from_numpy(tok),
                                     cfg)
        _close(log, jlog)
    assert int(state["pos"]) == int(state["ssm"]["pos"]) == S + 3
    _close_state(state, _np(jstate))


def test_decode_past_the_slack_wraps_as_the_reference():
    """A prompt of 32 and 70 decode steps: the cache of 32 + 64 slots
    wraps at step 64 in both packages (slot pos % cache_len)."""
    jcfg, cfg = _configs()
    jparams = j_get_model(jcfg).init_params(jax.random.PRNGKey(0), jcfg)
    params = from_numpy_tree(_np(jparams), "cpu")
    Sp, steps = 32, 70
    toks = _tokens(cfg, (1, Sp + steps), seed=6)
    jdecode = jax.jit(lambda p, s, t: j_hybrid.decode_step(p, s, t, jcfg,
                                                           CTX))
    _, jstate = j_hybrid.prefill(jparams, {"tokens": jnp.asarray(
        toks[:, :Sp])}, jcfg, CTX)
    _, state = hybrid.prefill(params, {"tokens": torch.from_numpy(
        toks[:, :Sp])}, cfg)
    cache_len = state["k"].shape[2]
    assert cache_len == Sp + hybrid.SLACK
    for t in range(Sp, Sp + steps):
        tok = toks[:, t:t + 1]
        jlog, jstate = jdecode(jparams, jstate, jnp.asarray(tok))
        log, state = hybrid.decode_step(params, state, torch.from_numpy(tok),
                                        cfg)
        _close(log, jlog)
    assert Sp + steps > cache_len
    np.testing.assert_array_equal(state["kpos"].numpy(),
                                  np.asarray(jstate["kpos"]))
    assert int(state["kpos"].max()) == Sp + steps - 1


def test_greedy_generate_matches_reference(models):
    jcfg, cfg, jparams, params = models
    toks = _tokens(cfg, (B, S), seed=2)
    want = JServer(jcfg, CTX, jparams).generate(
        {"tokens": jnp.asarray(toks)}, 6)
    got = Server(cfg, params, device="cpu").generate(
        {"tokens": torch.from_numpy(toks)}, 6)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_train_loss_matches_reference(models):
    jcfg, cfg, jparams, params = models
    toks = _tokens(cfg, (B, S + 1), seed=3)
    jbatch = {"tokens": jnp.asarray(toks[:, :-1]),
              "labels": jnp.asarray(toks[:, 1:])}
    want = j_get_model(jcfg).train_loss(jparams, jbatch, jcfg, CTX)
    got = get_model(cfg).train_loss(params, {
        "tokens": torch.from_numpy(toks[:, :-1]),
        "labels": torch.from_numpy(toks[:, 1:])}, cfg)
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4)


def test_bf16_prefill_logits_match_reference(monkeypatch):
    jcfg, cfg = _configs(dtype="bfloat16")
    jparams = j_get_model(jcfg).init_params(jax.random.PRNGKey(0), jcfg)
    params = from_numpy_tree(_np(jparams), "cpu")
    toks = _tokens(cfg, (B, S), seed=4)
    jlog, _ = j_get_model(jcfg).prefill(jparams, {"tokens": jnp.asarray(toks)},
                                        jcfg, CTX)
    tb = {"tokens": torch.from_numpy(toks)}
    log, state = get_model(cfg).prefill(params, tb, cfg)
    assert log.dtype == torch.float32 and state["k"].dtype == torch.bfloat16
    _close(log, jlog, rtol=0, atol=1e-1)
    # the reference's silu: exp, add, divide and multiply each in bf16
    monkeypatch.setattr(torch.nn.functional, "silu",
                        lambda x: x * (1 / (1 + torch.exp(-x))))
    log, _ = get_model(cfg).prefill(params, tb, cfg)
    _close(log, jlog, rtol=0, atol=6e-2)


def test_interop_carries_the_reference_trees_unchanged():
    """f32 and bf16 reference params cross leaf for leaf: same paths,
    shapes, dtypes and bits (bf16 as its raw 16 bits)."""
    for dtype in ("float32", "bfloat16"):
        jcfg, _ = _configs(dtype=dtype)
        jparams = _np(j_get_model(jcfg).init_params(jax.random.PRNGKey(0),
                                                    jcfg))
        params = from_numpy_tree(jparams, "cpu")
        want, _ = jax.tree_util.tree_flatten_with_path(jparams)
        got, _ = tree_flatten(params)
        assert len(got) == len(want)
        assert set(params) == set(jparams) == {
            "embed", "lm_head", "layers", "shared", "final_norm"}
        for g, (path, w) in zip(got, want):
            assert tuple(g.shape) == w.shape, path
            assert str(g.dtype).removeprefix("torch.") == w.dtype.name, path
            if dtype == "bfloat16":
                assert np.array_equal(g.view(torch.int16).numpy(),
                                      w.view(np.int16)), path
            else:
                assert np.array_equal(g.numpy(), w), path


def test_serve_with_recovery_flow():
    """examples/serve_with_recovery.py in the port: a lossless partial
    restore from a fresh running checkpoint gives identical tokens."""
    cfg = get_config(NAME, reduced=True)
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


def test_prompt_must_fill_whole_ssd_chunks():
    cfg = get_config(NAME, reduced=True)
    ops = get_model(cfg)
    params = ops.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    toks = torch.from_numpy(_tokens(cfg, (1, cfg.ssm_chunk + 8)))
    with pytest.raises(ValueError, match="divisible by chunk"):
        ops.prefill(params, {"tokens": toks}, cfg)
    logits, state = ops.prefill(params, {"tokens": toks[:, :24]}, cfg)
    assert logits.shape == (1, 1, cfg.vocab) and int(state["pos"]) == 24
