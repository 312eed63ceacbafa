"""The sliding-window attention kernel's plain version, its model-layout
wrapper and the plain chunked attention, port against reference.

- ``sw_attention_ref`` on the reference's test sweep
  (``tests/test_kernels.py``) against the reference's Pallas kernel in
  interpret mode: 1e-4 in f32, 5e-2 in bf16 (the sweep's own tolerances).
- ``ops.sw_attention`` in the model's (B, S, H, Dh) layout against the
  reference's ``ops.sw_attention(use_pallas=False)``: 1e-5.
- ``window = S`` is causal attention: it equals the port's
  ``flash_attention(causal=True, window=0)`` within 1e-5.
- ``layers.flash_attention`` against the reference's, for a prefill with a
  window and for a decode query over a ring cache with empty (-1) slots:
  1e-5.
- ``layers.attention_block`` (projections, RoPE, attention, output
  projection) against the reference's on its init weights: 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.sw_attention.kernel import sw_attention_pallas
from repro.kernels.sw_attention.ops import sw_attention as j_sw_attention
from repro.configs import get_config as j_get_config
from repro.models import layers as j_layers
from repro.sharding import single_device_ctx
from repro_torch.configs import get_config
from repro_torch.interop import from_numpy_tree
from repro_torch.kernels.sw_attention.ops import sw_attention
from repro_torch.kernels.sw_attention.ref import sw_attention_ref
from repro_torch.models import layers

SWEEP = [(2, 1, 64, 16, 16, 16, 16), (1, 2, 128, 32, 32, 32, 32),
         (2, 4, 96, 16, 24, 32, 16), (1, 1, 32, 8, 64, 16, 16)]


def _qkv(BH, G, S, Dh, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(BH, G, S, Dh)).astype(np.float32),
            rng.normal(size=(BH, S, Dh)).astype(np.float32),
            rng.normal(size=(BH, S, Dh)).astype(np.float32))


@pytest.mark.parametrize("dims", SWEEP)
def test_sw_attention_ref_matches_pallas(dims):
    BH, G, S, Dh, W, qc, kc = dims
    q, k, v = _qkv(BH, G, S, Dh, seed=S + W)
    got = sw_attention_ref(*map(torch.from_numpy, (q, k, v)), window=W)
    want = sw_attention_pallas(*map(jnp.asarray, (q, k, v)), window=W,
                               q_chunk=qc, kv_chunk=kc, interpret=True)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_sw_attention_ref_matches_pallas_bf16():
    BH, G, S, Dh, W = 1, 2, 64, 16, 16
    q, k, v = _qkv(BH, G, S, Dh, seed=7)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = sw_attention_ref(tq, tk, tv, window=W)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = sw_attention_pallas(jq, jk, jv, window=W, q_chunk=16, kv_chunk=16,
                               interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-2,
                               atol=5e-2)


def _model_qkv(B, S, Hq, Hk, Dh, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, S, Hq, Dh)).astype(np.float32),
            rng.normal(size=(B, S, Hk, Dh)).astype(np.float32),
            rng.normal(size=(B, S, Hk, Dh)).astype(np.float32))


@pytest.mark.parametrize("B,S,Hq,Hk,Dh,W", [(2, 40, 4, 2, 16, 12),
                                            (1, 33, 6, 1, 8, 33),
                                            (2, 24, 3, 3, 8, 100)])
def test_model_layout_matches_reference(B, S, Hq, Hk, Dh, W):
    q, k, v = _model_qkv(B, S, Hq, Hk, Dh, seed=S)
    got = sw_attention(*map(torch.from_numpy, (q, k, v)), window=W)
    want = j_sw_attention(*map(jnp.asarray, (q, k, v)), window=W,
                          use_pallas=False)
    assert got.shape == (B, S, Hq, Dh) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("S,chunk", [(64, 64), (70, 16)])
def test_window_of_s_is_causal_flash_attention(S, chunk):
    q, k, v = map(torch.from_numpy, _model_qkv(2, S, 6, 2, 16, seed=S))
    pos = torch.arange(S, dtype=torch.int32)
    band = sw_attention(q, k, v, window=S)
    causal = layers.flash_attention(q, k, v, pos, pos, causal=True, window=0,
                                    q_chunk=chunk, kv_chunk=chunk)
    torch.testing.assert_close(band, causal, rtol=1e-5, atol=1e-5)


def test_flash_attention_prefill_window_matches_reference():
    S, W = 96, 64
    q, k, v = _model_qkv(1, S, 4, 2, 16, seed=11)
    pos = np.arange(S, dtype=np.int32)
    got = layers.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                 torch.from_numpy(pos), torch.from_numpy(pos),
                                 causal=True, window=W, q_chunk=16,
                                 kv_chunk=16)
    want = j_layers.flash_attention(*map(jnp.asarray, (q, k, v)),
                                    jnp.asarray(pos), jnp.asarray(pos),
                                    causal=True, window=W, q_chunk=16,
                                    kv_chunk=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_flash_attention_decode_over_ring_matches_reference():
    W = 32
    q, _, _ = _model_qkv(2, 1, 4, 2, 16, seed=12)
    _, k, v = _model_qkv(2, W, 4, 2, 16, seed=13)
    # a ring after 40 tokens: slot s holds position 32 + s for s < 8, else
    # s; the new token (position 40) went into slot 8; slot 20 never filled
    kpos = np.array([32 + s if s < 8 else s for s in range(W)], np.int32)
    kpos[8], kpos[20] = 40, -1
    qpos = np.array([40], np.int32)
    args = (q, k, v, qpos, kpos)
    got = layers.flash_attention(*map(torch.from_numpy, args), causal=True,
                                 window=W, q_chunk=1, kv_chunk=8)
    want = j_layers.flash_attention(*map(jnp.asarray, args), causal=True,
                                    window=W, q_chunk=1, kv_chunk=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("window", [0, 24])
def test_attention_block_matches_reference(window):
    jcfg = j_get_config("qwen2-1.5b", reduced=True)
    cfg = get_config("qwen2-1.5b", reduced=True)
    jp = j_layers.init_attention(jax.random.PRNGKey(3), jcfg, jnp.float32)
    p = from_numpy_tree(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    S = 40
    x = np.random.default_rng(14).normal(
        size=(2, S, cfg.d_model)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)
    got = layers.attention_block(torch.from_numpy(x), p, cfg,
                                 positions=torch.from_numpy(pos),
                                 window=window, q_chunk=16, kv_chunk=16)
    want = j_layers.attention_block(jnp.asarray(x), jp, jcfg,
                                    single_device_ctx(),
                                    positions=jnp.asarray(pos),
                                    window=window, q_chunk=16, kv_chunk=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
