"""The encoder-decoder family (``models/encdec.py``, whisper-medium), port
against reference, on the reduced config.

Both packages get the reference's init params (``init_params`` on
``PRNGKey(0)``, carried with ``interop.from_numpy_tree``) and the same
numpy tokens and frames. On the CPU the decoder's causal self-attention
prefill runs the plain chunked ``flash_attention`` (the card's
``sw_attention``); the encoder and the cross-attention run it on every
device. The reduced ``enc_seq`` of 64 fills one encoder chunk;
``enc_seq=600`` leaves a padded last chunk of 88 frames (chunks of 512).
Checked:

- prefill logits and every cache entry: rtol 1e-4, atol 1e-4 (f32);
- three decode steps' logits at the same tolerance;
- ``Server.generate``'s greedy tokens, the frames in the batch: equal
  (``Server`` hands the prefill every key of the batch);
- ``train_loss``: rtol 1e-4;
- one bf16 prefill, logits only: atol 6e-2 (the gap measured on this
  test's inputs is 0.023, of logits up to about 3.7; over input seeds 0-5
  it is 0.020-0.026);
- ``examples/serve_with_recovery.py``'s flow: identical tokens after a
  lossless partial restore;
- ``layers.sinusoidal_positions`` against the reference's, with and
  without an offset: atol two f32 ulps of the largest angle, the largest
  position (XLA's and torch's ``exp`` of the frequencies differ by an ulp,
  which moves an angle near 1,500 rad by its ulp, 1.2e-4);
- a decode past the cache's last slot raises;
- ``lm_batch`` draws ``frames`` for the audio family only;
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
from repro.models import layers as j_layers
from repro.sharding import single_device_ctx
from repro.training.serve import Server as JServer
from repro_torch.configs import get_config
from repro_torch.core.controller import FTController
from repro_torch.core.policy import CheckpointPolicy
from repro_torch.data.synthetic import lm_batch
from repro_torch.interop import from_numpy_tree
from repro_torch.models import encdec, get_model
from repro_torch.models import layers as L
from repro_torch.training.serve import Server
from repro_torch.utils.tree import tree_flatten

NAME = "whisper-medium"
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


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().cpu().numpy(), np.asarray(want),
                               **(tol or TOL))


def _configs(**kw):
    return (dataclasses.replace(j_get_config(NAME, reduced=True), **kw),
            dataclasses.replace(get_config(NAME, reduced=True), **kw))


def _batch(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
            "frames": rng.standard_normal(
                (b, cfg.enc_seq, cfg.d_model)).astype(np.float32)}


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


@pytest.fixture(scope="module", params=[64, 600], ids=["one_chunk",
                                                       "padded_chunk"])
def models(request):
    jcfg, cfg = _configs(enc_seq=request.param)
    jparams = j_get_model(jcfg).init_params(jax.random.PRNGKey(0), jcfg)
    params = from_numpy_tree(_np(jparams), "cpu")
    return jcfg, cfg, jparams, params


def test_prefill_and_decode_match_reference(models):
    jcfg, cfg, jparams, params = models
    jops, ops = j_get_model(jcfg), get_model(cfg)
    batch = _batch(cfg, B, S + 3, seed=1)
    prompt = dict(batch, tokens=batch["tokens"][:, :S])
    jb, tb = _both(prompt)
    jlog, jcache = jops.prefill(jparams, jb, jcfg, CTX)
    log, cache = ops.prefill(params, tb, cfg)
    _close(log, jlog)
    jcache_np = _np(jcache)
    assert set(cache) == set(jcache_np)
    for key, want in jcache_np.items():
        assert tuple(cache[key].shape) == want.shape, key
        assert str(cache[key].dtype).removeprefix("torch.") == \
            want.dtype.name, key
        _close(cache[key], want)
    assert cache["cross_k"].shape[2] == cfg.enc_seq
    for t in range(S, S + 3):
        tok = batch["tokens"][:, t:t + 1]
        jlog, jcache = jops.decode_step(jparams, jcache, jnp.asarray(tok),
                                        jcfg, CTX)
        log, cache = ops.decode_step(params, cache, torch.from_numpy(tok),
                                     cfg)
        _close(log, jlog)
    assert int(cache["pos"]) == S + 3
    for key, want in _np(jcache).items():
        _close(cache[key], want)


def test_greedy_generate_matches_reference(models):
    """``Server.generate`` hands the frames to the prefill: the port's
    tokens are the reference's, and differ from a generate whose frames
    were dropped (zeros)."""
    jcfg, cfg, jparams, params = models
    batch = _batch(cfg, B, S, seed=2)
    jb, tb = _both(batch)
    want = JServer(jcfg, CTX, jparams).generate(jb, 6)
    srv = Server(cfg, params, device="cpu")
    got = srv.generate(tb, 6)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    logits, _ = get_model(cfg).prefill(params, tb, cfg)
    zeros, _ = get_model(cfg).prefill(
        params, dict(tb, frames=torch.zeros_like(tb["frames"])), cfg)
    assert not torch.allclose(logits, zeros)


def test_train_loss_matches_reference(models):
    jcfg, cfg, jparams, params = models
    batch = _batch(cfg, B, S + 1, seed=3)
    full = batch["tokens"]
    batch = dict(batch, tokens=full[:, :-1], labels=full[:, 1:].copy())
    jb, tb = _both(batch)
    want = j_get_model(jcfg).train_loss(jparams, jb, jcfg, CTX)
    got = get_model(cfg).train_loss(params, tb, cfg)
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4)


def test_bf16_prefill_logits_match_reference():
    jcfg, cfg = _configs(dtype="bfloat16")
    jparams = j_get_model(jcfg).init_params(jax.random.PRNGKey(0), jcfg)
    params = from_numpy_tree(_np(jparams), "cpu")
    jb, tb = _both(_batch(cfg, B, S, seed=4))
    jlog, _ = j_get_model(jcfg).prefill(jparams, jb, jcfg, CTX)
    log, cache = get_model(cfg).prefill(params, tb, cfg)
    assert log.dtype == torch.float32
    assert cache["k"].dtype == cache["cross_k"].dtype == torch.bfloat16
    _close(log, jlog, rtol=0, atol=6e-2)


@pytest.mark.parametrize("offset", [0, 37])
def test_sinusoidal_positions_match_reference(offset):
    for seq, d in ((16, 256), (1500, 1024), (1, 1024)):
        atol = 2 * float(np.spacing(np.float32(seq + offset)))
        want = np.asarray(j_layers.sinusoidal_positions(seq, d, offset))
        got = L.sinusoidal_positions(seq, d, offset)
        assert got.dtype == torch.float32 and got.shape == (seq, d)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)
        # a decode step's position as a 0-d tensor
        got = L.sinusoidal_positions(1, d, torch.tensor(offset + seq,
                                                        dtype=torch.int32))
        want = np.asarray(j_layers.sinusoidal_positions(
            1, d, jnp.asarray(offset + seq, jnp.int32)))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)


def test_decode_past_the_last_slot_raises():
    """The cache holds the prompt and 64 empty slots; a decode with no
    slot left raises (the reference would clamp its write to the last slot
    and drop the ``kpos`` update)."""
    cfg = get_config(NAME, reduced=True)
    ops = get_model(cfg)
    params = ops.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    _, tb = _both(_batch(cfg, 1, 8, seed=5))
    _, cache = ops.prefill(params, tb, cfg)
    cache_len = cache["k"].shape[2]
    assert cache_len == 8 + encdec.SLACK
    tok = tb["tokens"][:, :1]
    cache["pos"] = torch.tensor(cache_len - 1, dtype=torch.int32)
    logits, cache = ops.decode_step(params, cache, tok, cfg)
    assert int(cache["kpos"][-1]) == cache_len - 1
    k_before = cache["k"].clone()
    with pytest.raises(ValueError, match="slots"):
        ops.decode_step(params, cache, tok, cfg)
    assert torch.equal(cache["k"], k_before) and int(cache["pos"]) == \
        cache_len


def test_lm_batch_draws_frames_for_the_audio_family():
    gen = torch.Generator().manual_seed(0)
    for dtype, want in (("float32", torch.float32),
                        ("bfloat16", torch.bfloat16)):
        cfg = dataclasses.replace(get_config(NAME, reduced=True),
                                  dtype=dtype)
        b = lm_batch(gen, cfg, 3, 16, device="cpu")
        assert set(b) == {"tokens", "labels", "frames"}
        assert b["frames"].shape == (3, cfg.enc_seq, cfg.d_model)
        assert b["frames"].dtype == want
        assert b["tokens"].shape == (3, 16) and b["tokens"].dtype == \
            torch.int32
        assert 0.5 < float(b["frames"].float().std()) < 1.5
    b = lm_batch(gen, get_config("zamba2-1.2b", reduced=True), 3, 16,
                 device="cpu")
    assert set(b) == {"tokens", "labels"}


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
            "embed", "lm_head", "frame_proj", "enc_layers", "enc_norm",
            "dec_layers", "final_norm"}
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
    _, batch = _both(_batch(cfg, 4, 32, seed=6))
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
