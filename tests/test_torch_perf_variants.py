"""The perf variants, port against reference: the int8 KV cache
(``quantize_kv``, ``flash_attention_kvq``, the ``kv_quant`` cache in
``prefill`` and ``decode_step``) and the triangle prefill
(``flash_attention_triangle``), on the CPU.

Inputs are drawn with the reference (``init_params`` on ``PRNGKey(0)``,
``lm_batch`` on ``PRNGKey(1)``, its ``quantize_kv`` for the int8 inputs)
or with numpy, and cross as numpy (``interop.from_numpy_tree``). Checked:

- ``quantize_kv``: int8 values and scales bit for bit against the
  reference's eager call, f32 and bf16 inputs, zero rows included (the
  reference's jitted form may differ: XLA turns its division by 127 into a
  product with the reciprocal, which moves the last bit of some scales);
- ``flash_attention_kvq`` and ``flash_attention_triangle``: rtol 1e-4,
  atol 1e-4 (f32; the two frameworks order their sums differently, and the
  port groups the query heads as (Hk, G) where the reference repeats k/v);
- the reference's four serve tests (``tests/test_perf_variants.py``) at
  the reduced configs it names, with its bounds (triangle against the
  baseline rtol 2e-3, atol 2e-3; the int8 decode's next-token
  probabilities within 0.05 of the bf16 cache's), each also held to the
  reference's own outputs at rtol 1e-4, atol 1e-4;
- the ``kv_quant`` prefill's cache against the reference's: scales rtol
  1e-5, every empty slot's scale exactly ``1e-8 / 127``, the int8 values
  equal or one count apart where the two packages' f32 projections round
  apart (the flips are counted and bounded); the ring prefill's too;
- the port's ``decode_step`` on the reference's own int8 cache: logits
  rtol 1e-4, atol 1e-4;
- the int8 decode repeats no cache over G and makes no float tensor as
  large as one layer's cache.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as j_get_config
from repro.data import lm_batch as j_lm_batch
from repro.models import get_model as j_get_model
from repro.models import layers as j_layers
from repro.models import transformer as j_transformer
from repro.sharding import single_device_ctx
from repro_torch.configs import get_config
from repro_torch.interop import from_numpy_tree
from repro_torch.models import get_model, layers, transformer

TOL = dict(rtol=1e-4, atol=1e-4)
CTX = single_device_ctx()


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while these tests run (several workers share a
    few cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.detach().float()),
                               np.asarray(want, np.float32), **(tol or TOL))


def _pair(name, **flags):
    """(reference cfg, port cfg) of ``name`` reduced, with ``flags``."""
    return (dataclasses.replace(j_get_config(name, reduced=True), **flags),
            dataclasses.replace(get_config(name, reduced=True), **flags))


def _params(jcfg):
    """The reference's init params, and the port's numpy copy of them."""
    jparams = j_get_model(jcfg).init_params(jax.random.PRNGKey(0), jcfg)
    return jparams, from_numpy_tree(_np(jparams), "cpu")


def _batch(jcfg, batch, seq):
    """The reference's ``lm_batch`` on ``PRNGKey(1)``: (jax batch, torch
    batch) of the prefill's keys."""
    jb = j_lm_batch(jax.random.PRNGKey(1), jcfg, batch, seq)
    jb = {k: v for k, v in jb.items() if k in ("tokens", "patches")}
    return jb, {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}


# ---------------------------------------------------------------------------
# the functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_bit_for_bit(dtype):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 40, 4, 64))
         * rng.uniform(1e-4, 30.0, (3, 40, 4, 1))).astype(np.float32)
    x[0, :5] = 0.0                      # zero rows: the cache's empty slots
    x[1, 3, 2] = 0.0
    xj = jnp.asarray(x, getattr(jnp, dtype))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    want_q, want_s = j_layers.quantize_kv(xj)
    got_q, got_s = layers.quantize_kv(xt)
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    assert float(got_s[0, 0, 0]) == float(np.float32(1e-8) / np.float32(127))
    assert not got_q[0, :5].any()
    # the reference's own round-trip bound
    back = got_q.float() * got_s[..., None]
    xf = xt.float()
    assert float((back - xf).abs().max() / xf.abs().max()) < 0.01


def _kvq_inputs(B, Sq, Hk, G, Skv, Dh, seed, holes=False):
    """q (f32), the reference-quantized int8 k/v and scales, qpos, kpos."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, Hk * G, Dh)).astype(np.float32)
    k = rng.standard_normal((B, Skv, Hk, Dh)).astype(np.float32)
    v = rng.standard_normal((B, Skv, Hk, Dh)).astype(np.float32)
    k8, ks = j_layers.quantize_kv(jnp.asarray(k))
    v8, vs = j_layers.quantize_kv(jnp.asarray(v))
    if holes:                           # a ring: slot s holds position p
        last = Skv + 5
        kpos = np.array([p if p <= last else -1 for p in
                         (last - (last - s) % Skv for s in range(Skv))],
                        np.int32)
        kpos[[1, 7]] = -1
        qpos = np.array([last] * Sq, np.int32)
    else:
        kpos = np.arange(Skv, dtype=np.int32)
        qpos = np.arange(Skv - Sq, Skv, dtype=np.int32)
    return [q, *map(np.array, (k8, v8, ks, vs)), qpos, kpos]


@pytest.mark.parametrize("B,Sq,Hk,G,Skv,Dh,window,kv_chunk,holes", [
    (2, 1, 2, 1, 64, 32, 0, 16, False),     # G 1
    (2, 1, 2, 4, 70, 32, 0, 16, False),     # G > 1, a short last chunk
    (1, 3, 2, 3, 48, 16, 0, 64, False),     # several queries, one chunk
    (2, 1, 2, 2, 64, 32, 0, 16, True),      # a ring with -1 slots
    (2, 1, 1, 4, 96, 32, 20, 32, False),    # a window
    (1, 1, 2, 2, 64, 32, 24, 16, True),     # a ring with a window
])
def test_flash_attention_kvq_matches_reference(B, Sq, Hk, G, Skv, Dh, window,
                                               kv_chunk, holes):
    ins = _kvq_inputs(B, Sq, Hk, G, Skv, Dh, seed=Skv + G, holes=holes)
    want = j_layers.flash_attention_kvq(
        *map(jnp.asarray, ins), window=window, kv_chunk=kv_chunk)
    got = layers.flash_attention_kvq(
        *map(torch.from_numpy, ins), window=window, kv_chunk=kv_chunk)
    assert got.shape == (B, Sq, Hk * G, Dh) and got.dtype == torch.float32
    _close(got, want)


def test_flash_attention_kvq_is_flash_attention_over_the_dequantized_cache():
    """Over the dequantized cache the baseline attention gives the same
    output (the scales applied in f32 per chunk, as a dequantized copy)."""
    q, k8, v8, ks, vs, qpos, kpos = map(torch.from_numpy, _kvq_inputs(
        2, 1, 2, 4, 80, 32, seed=3, holes=True))
    got = layers.flash_attention_kvq(q, k8, v8, ks, vs, qpos, kpos,
                                     kv_chunk=32)
    want = layers.flash_attention(q, k8.float() * ks[..., None],
                                  v8.float() * vs[..., None], qpos, kpos,
                                  q_chunk=1, kv_chunk=32)
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("B,S,Hk,G,Dh,chunk", [
    (2, 64, 2, 2, 32, 16),      # S a multiple of the chunk
    (1, 50, 2, 3, 16, 16),      # S not a multiple: padded rows and keys
    (2, 24, 1, 1, 32, 32),      # one chunk
])
def test_flash_attention_triangle_matches_reference(B, S, Hk, G, Dh, chunk):
    rng = np.random.default_rng(S)
    q = rng.standard_normal((B, S, Hk * G, Dh)).astype(np.float32)
    k = rng.standard_normal((B, S, Hk, Dh)).astype(np.float32)
    v = rng.standard_normal((B, S, Hk, Dh)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)
    want = j_layers.flash_attention_triangle(
        *map(jnp.asarray, (q, k, v, pos, pos)), q_chunk=chunk,
        kv_chunk=chunk)
    got = layers.flash_attention_triangle(
        *map(torch.from_numpy, (q, k, v, pos, pos)), q_chunk=chunk,
        kv_chunk=chunk)
    _close(got, want)
    # and the port's own baseline, which visits every tile
    base = layers.flash_attention(*map(torch.from_numpy, (q, k, v, pos, pos)),
                                  q_chunk=chunk, kv_chunk=chunk)
    torch.testing.assert_close(got, base, **TOL)


# ---------------------------------------------------------------------------
# the reference's serve tests (tests/test_perf_variants.py), ported
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["yi-9b", "qwen3-moe-235b-a22b",
                                  "llama4-maverick-400b-a17b"])
def test_triangle_prefill_matches_baseline(name):
    jbase, base = _pair(name)
    jtri, tri = _pair(name, triangle_prefill=True)
    jparams, params = _params(jbase)
    jb, tb = _batch(jbase, 2, 64)
    lp_b, _ = get_model(base).prefill(params, tb, base)
    lp_t, _ = get_model(tri).prefill(params, tb, tri)
    torch.testing.assert_close(lp_t, lp_b, rtol=2e-3, atol=2e-3)
    want, _ = j_get_model(jtri).prefill(jparams, jb, jtri, CTX)
    _close(lp_t, want)


@pytest.mark.parametrize("name", ["yi-9b", "llama4-maverick-400b-a17b"])
def test_kv_quant_decode_close_to_baseline(name):
    jbase, base = _pair(name)
    jq, cq = _pair(name, kv_quant=True)
    jparams, params = _params(jbase)
    tok = torch.zeros((2, 1), dtype=torch.int32)
    ops, opsq = get_model(base), get_model(cq)
    c_b = ops.init_cache(base, 2, 64, device="cpu")
    _, c_b = ops.decode_step(params, c_b, tok, base)
    l_b2, _ = ops.decode_step(params, c_b, tok + 1, base)
    c_q = opsq.init_cache(cq, 2, 64, device="cpu")
    assert c_q["k"].dtype == torch.int8
    assert c_q["k_scale"].shape == c_q["k"].shape[:-1]
    l_q, c_q = opsq.decode_step(params, c_q, tok, cq)
    l_q2, _ = opsq.decode_step(params, c_q, tok + 1, cq)
    p_b = torch.softmax(l_b2[:, -1], dim=-1)
    p_q = torch.softmax(l_q2[:, -1], dim=-1)
    assert float((p_b - p_q).abs().max()) < 0.05
    # the reference's int8 decode, step for step
    jops = j_get_model(jq)
    jc = jops.init_cache(jq, 2, 64, CTX)
    jl, jc = jops.decode_step(jparams, jc, jnp.zeros((2, 1), jnp.int32), jq,
                              CTX)
    jl2, _ = jops.decode_step(jparams, jc, jnp.ones((2, 1), jnp.int32), jq,
                              CTX)
    _close(l_q, jl)
    _close(l_q2, jl2)


def test_kv_quant_prefill_then_decode():
    """The decode step is held to the reference's decode on the port's
    own int8 cache: the two prefills' caches may sit one int8 count apart
    (``test_kv_quant_prefill_cache_matches_reference``; here one v value,
    which moves the next logits by up to 4.6e-4)."""
    jq, cq = _pair("granite-8b", kv_quant=True)
    jparams, params = _params(jq)
    jb, tb = _batch(jq, 2, 32)
    ops = get_model(cq)
    logits, cache = ops.prefill(params, tb, cq)
    assert cache["k"].dtype == torch.int8 and cache["v"].dtype == torch.int8
    carried = {k: jnp.asarray(v.numpy()) for k, v in cache.items()}
    tok = np.zeros((2, 1), np.int32)
    l2, _ = ops.decode_step(params, cache, torch.from_numpy(tok), cq)
    assert bool(torch.isfinite(l2).all())
    jops = j_get_model(jq)
    jlogits, _ = jops.prefill(jparams, jb, jq, CTX)
    jl2, _ = jops.decode_step(jparams, carried, jnp.asarray(tok), jq, CTX)
    _close(logits, jlogits)
    _close(l2, jl2)


def test_moe_reduce_scatter_single_device_noop():
    """Without a mesh the flag must not change results."""
    jbase, base = _pair("qwen3-moe-235b-a22b")
    _, cfgr = _pair("qwen3-moe-235b-a22b", moe_reduce_scatter=True)
    jparams, params = _params(jbase)
    jb = j_lm_batch(jax.random.PRNGKey(1), jbase, 2, 64)
    tb = {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}
    l1 = get_model(base).train_loss(params, tb, base)
    l2 = get_model(cfgr).train_loss(params, tb, cfgr)
    assert float(l1) == pytest.approx(float(l2), rel=1e-6)
    want = j_get_model(jbase).train_loss(jparams, jb, jbase, CTX)
    assert float(l2) == pytest.approx(float(want), rel=1e-4)


# ---------------------------------------------------------------------------
# the int8 cache against the reference's
# ---------------------------------------------------------------------------

def _hold_int8_cache(got, want, name, live_slots):
    """Scales within rtol 1e-5, each empty slot's exactly ``1e-8 / 127``;
    int8 values equal or one count apart, the flips few. Returns the flip
    count."""
    empty = float(np.float32(1e-8) / np.float32(127))
    flips = 0
    for key in ("k", "v"):
        g, w = got[key].numpy().astype(np.int32), np.asarray(want[key],
                                                             np.int32)
        d = np.abs(g - w)
        assert d.max() <= 1, f"{name} {key}: int8 {d.max()} counts apart"
        flips += int(d.sum())
        gs, ws = got[key + "_scale"].numpy(), np.asarray(want[key + "_scale"])
        np.testing.assert_allclose(gs, ws, rtol=1e-5, atol=0)
        assert (gs[:, :, ~live_slots] == empty).all()
        assert (ws[:, :, ~live_slots] == empty).all()
    # one count flips only where x / scale lands within the projections'
    # f32 rounding of a half: a handful in tens of thousands of values
    assert flips <= 1e-3 * got["k"].numel(), f"{name}: {flips} int8 flips"
    np.testing.assert_array_equal(got["kpos"].numpy(),
                                  np.asarray(want["kpos"]))
    return flips


@pytest.mark.parametrize("name,seen", [("granite-8b", 0),
                                       ("qwen3-moe-235b-a22b", 0),
                                       ("llama4-maverick-400b-a17b", 0),
                                       ("internvl2-76b", 1)])
def test_kv_quant_prefill_cache_matches_reference(name, seen):
    """The prefill quantizes each layer's model-dtype K/V as it writes
    them; the reference quantizes the finished cache (the 64 slack slots
    too). Flips seen on these inputs (f32, 45,056 or 53,248 int8 values a
    tensor): none, except one in internvl2-76b's; held to at most that."""
    jq, cq = _pair(name, kv_quant=True)
    jparams, params = _params(jq)
    jb, tb = _batch(jq, 2, 24)
    logits, cache = get_model(cq).prefill(params, tb, cq)
    jlogits, jcache = j_get_model(jq).prefill(jparams, jb, jq, CTX)
    _close(logits, jlogits)
    S = cache["kpos"].shape[0] - 64
    assert cache["k"].shape[2] == S + 64 and int(cache["pos"]) == S
    live = np.arange(S + 64) < S
    assert _hold_int8_cache(cache, jcache, name, live) <= seen


def test_kv_quant_ring_prefill_cache_matches_reference():
    """A ring prefill (S 96 over the reduced window of 64): every slot
    holds a token, placed at ``pos % W``."""
    jq, cq = _pair("yi-9b", kv_quant=True)
    jparams, params = _params(jq)
    jb, tb = _batch(jq, 2, 96)
    spec = transformer.cache_spec(cq, 96, use_window=True)
    jspec = j_transformer.cache_spec(jq, 96, use_window=True)
    assert spec.ring and spec.cache_len == 64
    logits, cache = transformer.prefill(params, tb, cq, spec)
    jlogits, jcache = j_transformer.prefill(jparams, jb, jq, CTX, jspec)
    _close(logits, jlogits)
    assert _hold_int8_cache(cache, jcache, "yi-9b ring",
                            np.ones(64, bool)) == 0
    # and a ring decode step on it, against the reference's
    tok = np.ones((2, 1), np.int32)
    l2, _ = get_model(cq).decode_step(params, cache, torch.from_numpy(tok),
                                      cq)
    jl2, _ = j_get_model(jq).decode_step(jparams, jcache, jnp.asarray(tok),
                                         jq, CTX)
    _close(l2, jl2)


@pytest.mark.parametrize("name", ["yi-9b", "llama4-maverick-400b-a17b"])
def test_decode_step_on_the_reference_int8_cache(name):
    """The reference's own int8 cache (from its prefill) carried to the
    port with ``from_numpy_tree``: three decode steps' logits."""
    jq, cq = _pair(name, kv_quant=True)
    jparams, params = _params(jq)
    jb, _ = _batch(jq, 2, 40)
    jops, ops = j_get_model(jq), get_model(cq)
    _, jcache = jops.prefill(jparams, jb, jq, CTX)
    cache = from_numpy_tree(_np(jcache), "cpu")
    assert cache["k"].dtype == torch.int8
    for step in range(3):
        tok = np.full((2, 1), 5 + step, np.int32)
        jl, jcache = jops.decode_step(jparams, jcache, jnp.asarray(tok), jq,
                                      CTX)
        tl, cache = ops.decode_step(params, cache, torch.from_numpy(tok), cq)
        _close(tl, jl)


class _LargestFloat(TorchDispatchMode):
    """Records the largest floating-point tensor any op makes."""

    def __init__(self):
        super().__init__()
        self.largest = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(t, torch.Tensor) and t.is_floating_point():
                self.largest = max(self.largest, t.numel())
        return out


def test_int8_decode_repeats_no_cache_over_the_group(monkeypatch):
    """A decode step over the int8 cache never repeats k/v over G, and no
    float tensor it makes comes near one layer's cache: its f32 peak is
    one chunk's k and v. A linear cache of 16,384 slots, so that a layer's
    cache outweighs every weight of the reduced model."""
    _, cq = _pair("yi-9b", kv_quant=True, attn_chunk=256, sliding_window=0)
    ops = get_model(cq)
    params = ops.init_params(torch.Generator().manual_seed(0), cq,
                             device="cpu")
    cache = ops.init_cache(cq, 2, 16384, device="cpu")
    assert cache["k"].shape[2] == 16384

    def no_repeat(*args, **kwargs):
        raise AssertionError("the cache was repeated over the group")
    monkeypatch.setattr(torch, "repeat_interleave", no_repeat)
    with _LargestFloat() as mode:
        logits, _ = ops.decode_step(
            params, cache, torch.zeros((2, 1), dtype=torch.int32), cq)
    assert bool(torch.isfinite(logits).all())
    layer_cache = cache["k"][0].numel()
    chunk = 2 * 256 * cq.n_kv_heads * cq.head_dim
    assert chunk < mode.largest * 4 and mode.largest < layer_cache // 4
