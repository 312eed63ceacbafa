"""The LM trainer's slice of the port against the reference, on the CPU.

Both packages get the same inputs: numpy draws, the reference's init
params (``init_params`` on a ``PRNGKey``) carried with
``interop.from_numpy_tree``, and ``ShardedLMDataset``'s tokens, which both
draw from ``np.random.default_rng(seed)``. Reduced configs, batch 2 x 32,
at most 6 steps. Tolerances:

- the value domain (``pack_values``, ``decode_values``, ``encode_values``):
  bit-exact on f32 and on mixed bf16/f16/f32 layouts with tail-packed
  leaves: both packages bitcast and round to nearest even;
- one optimizer step, port against reference: rtol 1e-6 (one f32 rounding
  of the same elementwise formula; XLA and torch may fuse differently);
  ``arena_apply`` against the per-leaf tree update within the port:
  bit-exact (the same elementwise function on other slices);
- ``_flash`` forward and its dq/dk/dv, ``lm_loss_chunked`` and its grads:
  rtol 1e-5, with an absolute floor of 1e-6 of the largest magnitude (the
  two frameworks sum their f32 einsums in other orders; a gradient entry
  near zero has no relative precision);
- ``train_loss``: the loss within rtol 1e-5, each leaf's gradient within
  1e-4 relative L2; remat on equals remat off bit for bit;
- the trainer: arena and PyTree paths bit-exact; port against reference
  losses within rtol 1e-4 over 6 steps, ``saved_iter`` and tier counts
  equal after a scheduled host loss.

The four trainable families: dense (qwen2-1.5b), ssm (mamba2-370m),
hybrid (zamba2-1.2b: a Mamba2 backbone and one shared attention block)
and audio (whisper-medium: an encoder-decoder whose batches carry
``frames``, drawn with numpy in the reference's order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core import arena as j_arena
from repro.core.blocks import partition_pytree as j_partition
from repro.core.policy import CheckpointPolicy as JPolicy
from repro.data.pipeline import ShardedLMDataset as JDataset
from repro.fabric import FabricConfig as JFabric
from repro.models import get_model as j_get_model
from repro.models import layers as j_layers
from repro.optim import optimizers as j_opt
from repro.sharding import single_device_ctx
from repro.training import TrainLoop as JLoop
from repro.training import TrainLoopConfig as JLoopConfig
from repro_torch.configs import get_config
from repro_torch.core import arena as t_arena
from repro_torch.core.blocks import partition_pytree
from repro_torch.core.policy import CheckpointPolicy
from repro_torch.data import ShardedLMDataset
from repro_torch.fabric import FabricConfig
from repro_torch.interop import from_numpy_tree
from repro_torch.models import get_model
from repro_torch.models import layers as t_layers
from repro_torch.optim import optimizers as t_opt
from repro_torch.training import (ArenaTrainState, TrainLoop,
                                  TrainLoopConfig, TrainState)
from repro_torch.training.step import (make_arena_train_step,
                                       make_train_step)
from repro_torch.utils.tree import tree_leaves, tree_map

CTX = single_device_ctx()
ARCHS = ["qwen2-1.5b", "mamba2-370m", "zamba2-1.2b", "whisper-medium"]
B, S = 2, 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while these tests run: the suite runs several
    workers on a few cores, and spinning torch threads would starve the
    JAX programs that other workers run meanwhile."""
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


def _ref_params(name, seed=0):
    cfg = j_get_config(name, reduced=True)
    return cfg, _np(j_get_model(cfg).init_params(jax.random.PRNGKey(seed),
                                                 cfg))


# ---------------------------------------------------------------------------
# the arena's value domain
# ---------------------------------------------------------------------------

def _mixed_tree(rng, dtypes):
    shapes = [(70, 9), (33, 5), (7,), (3, 4), (300, 3), ()]
    return {f"l{i}": rng.normal(size=s).astype(np.float32).astype(dt)
            for i, (s, dt) in enumerate(zip(shapes, dtypes))}


LAYOUTS = {
    "f32": [np.float32] * 6,
    "bf16_f16_tail": [np.float32, jnp.bfloat16, np.float16, jnp.bfloat16,
                      np.float16, np.float32],
    "all_bf16": [jnp.bfloat16] * 6,
}


@pytest.mark.parametrize("kind", sorted(LAYOUTS))
def test_value_domain_bit_exact(kind):
    rng = np.random.default_rng(3)
    tree = _mixed_tree(rng, LAYOUTS[kind])
    jt = {k: jnp.asarray(v) for k, v in tree.items()}
    tt = from_numpy_tree(tree, "cpu")
    jl = j_arena.build_arena_layout(j_partition(jt, 16))
    tl = t_arena.build_arena_layout(partition_pytree(tt, 16))
    assert tl.has_tail and tl.total_values == jl.total_values
    assert tl.uniform_f32 == jl.uniform_f32 == (kind == "f32")
    assert [(r[0], r[1], r[2], r[3]) for r in tl.value_runs()] \
        == [(r[0], r[1], r[2], r[3]) for r in jl.value_runs()]
    for f in ("payload_elems", "seg_elems", "value_offset"):
        assert getattr(tl, f) == getattr(jl, f)
    # pack_values of the tree, as f32 values
    jv = np.asarray(j_arena.pack_values(jt, jl))
    tv = t_arena.pack_values(tt, tl).numpy()
    assert np.array_equal(jv.view(np.int32), tv.view(np.int32))
    # decode_values of the word arena
    jw = j_arena.pack_arena(jt, jl)
    tw = t_arena.pack_arena(tt, tl)
    assert np.array_equal(np.asarray(jw).view(np.int32), tw.numpy())
    jd = np.asarray(j_arena.decode_values(jw, jl))
    td = t_arena.decode_values(tw, tl).numpy()
    assert np.array_equal(jd.view(np.int32), td.view(np.int32))
    # encode_values of perturbed values: the rounding to each run's dtype
    # (round to nearest even) and the pads' zero bits
    noise = rng.normal(size=jv.shape).astype(np.float32) * 1e-3
    vals = np.where(jv != 0, jv + noise, 0).astype(np.float32)
    je = np.asarray(j_arena.encode_values(jnp.asarray(vals), jl))
    te = t_arena.encode_values(torch.from_numpy(vals.copy()), tl).numpy()
    assert np.array_equal(je.view(np.int32), te)
    # the round trip decodes to the values themselves where they are exact
    back = t_arena.decode_values(torch.from_numpy(te.copy()), tl)
    assert torch.equal(t_arena.encode_values(back, tl),
                       torch.from_numpy(te.copy()))


def test_value_domain_rounds_to_nearest_even():
    """Halfway f32 values round to the even bf16 and f16, as ``astype``."""
    tree = {"h": np.zeros((1024,), np.float32).astype(jnp.bfloat16),
            "f": np.zeros((1024,), np.float16)}
    jt = {k: jnp.asarray(v) for k, v in tree.items()}
    tl = t_arena.build_arena_layout(partition_pytree(
        from_numpy_tree(tree, "cpu"), 2048))
    jl = j_arena.build_arena_layout(j_partition(jt, 2048))
    rng = np.random.default_rng(5)
    base = rng.normal(size=(tl.total_values,)).astype(np.float32)
    # set the bits just below bf16's last kept bit to exactly one half
    bits = base.view(np.uint32) & np.uint32(0xFFFF0000) | np.uint32(0x8000)
    halfway = bits.view(np.float32)
    je = np.asarray(j_arena.encode_values(jnp.asarray(halfway), jl))
    te = t_arena.encode_values(torch.from_numpy(halfway.copy()), tl).numpy()
    assert np.array_equal(je.view(np.int32), te)


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

OPTS = {"sgd": dict(lr=0.1), "momentum": dict(lr=0.1, beta=0.9),
        "adam": dict(lr=1e-2), "adamw": dict(lr=1e-2, wd=0.01)}


@pytest.mark.parametrize("name", sorted(OPTS))
def test_optimizer_against_reference(name):
    rng = np.random.default_rng(1)
    params = {"w": rng.normal(size=(40, 7)).astype(np.float32),
              "b": rng.normal(size=(7,)).astype(np.float32)}
    jopt = getattr(j_opt, name)(**OPTS[name])
    topt = getattr(t_opt, name)(**OPTS[name])
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = from_numpy_tree(params, "cpu")
    js, ts = jopt.init(jp), topt.init(tp)
    for _ in range(3):
        g = {k: rng.normal(size=v.shape).astype(np.float32)
             for k, v in params.items()}
        jp, js = jopt.update({k: jnp.asarray(v) for k, v in g.items()},
                             js, jp)
        tp, ts = topt.update(from_numpy_tree(g, "cpu"), ts, tp)
    assert int(ts.step) == int(js.step) == 3
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", sorted(OPTS))
def test_arena_apply_matches_tree_update(name):
    """The port's flat in-place apply over the word arena equals its
    per-leaf tree update bit for bit, the bf16/f16 round trip included;
    pads stay zero (I4). Mirrors ``tests/test_arena_state.py``'s test of
    the reference; the slice is cut small so the apply walks several."""
    rng = np.random.default_rng(0)
    params = from_numpy_tree(
        {"w": rng.normal(size=(70, 9)).astype(np.float32),
         "h": rng.normal(size=(33, 5)).astype(np.float32).astype(
             jnp.bfloat16),
         "b": rng.normal(size=(7,)).astype(np.float16)}, "cpu")
    part = partition_pytree(params, 16)
    layout = t_arena.build_arena_layout(part)
    assert not layout.uniform_f32 \
        and layout.total_values > layout.total_words
    opt = getattr(t_opt, name)(**OPTS[name])
    arena = t_arena.pack_arena(params, layout)
    st_tree = opt.init(params)
    st_flat = opt.init(torch.zeros((layout.total_values,)))
    tree = params
    old = t_opt.APPLY_SLICE
    t_opt.APPLY_SLICE = 256
    try:
        for i in range(3):
            grads = tree_map(lambda x: torch.from_numpy(rng.normal(
                size=tuple(x.shape)).astype(np.float32)).to(x.dtype), tree)
            g_values = t_arena.pack_values(grads, layout)
            tree, st_tree = opt.update(grads, st_tree, tree)
            arena, st_flat = t_opt.arena_apply(opt, g_values, st_flat,
                                               arena, layout)
            assert torch.equal(t_arena.pack_arena(tree, layout), arena), \
                f"step {i} diverged"
    finally:
        t_opt.APPLY_SLICE = old
    pad = np.ones((layout.total_words,), bool)
    vpad = np.ones((layout.total_values,), bool)
    for li, leaf in enumerate(part.leaves):
        off, seg, pay = (layout.leaf_offset[li], layout.seg_words[li],
                         layout.payload_words[li])
        voff, vseg, vpay = (layout.value_offset[li], layout.seg_elems[li],
                            layout.payload_elems[li])
        for b in range(leaf.n_blocks):
            pad[off + b * seg:off + b * seg + pay] = False
            vpad[voff + b * vseg:voff + b * vseg + vpay] = False
    assert (arena.numpy()[pad] == 0).all()
    for m in (st_flat.mu, st_flat.nu):
        if isinstance(m, torch.Tensor):
            assert (m.numpy()[vpad] == 0).all()


# ---------------------------------------------------------------------------
# flash attention's backward and the chunked loss
# ---------------------------------------------------------------------------

FLASH = [
    # (B, Sq, Hq, Hk, Dh, causal, window, q_chunk, kv_chunk)
    (2, 48, 4, 2, 16, True, 0, 16, 16),       # GQA, causal
    (1, 50, 6, 2, 8, True, 12, 16, 8),        # window, padded chunks
    (2, 40, 2, 2, 8, False, 0, 16, 32),       # non-causal, padded
    (1, 64, 8, 1, 16, True, 0, 64, 16),       # MQA
]


@pytest.mark.parametrize("dims", FLASH)
def test_flash_forward_and_grads_against_reference(dims):
    Bq, Sq, Hq, Hk, Dh, causal, W, qc, kc = dims
    rng = np.random.default_rng(2)
    q, k, v, do = (rng.normal(size=s).astype(np.float32) for s in (
        (Bq, Sq, Hq, Dh), (Bq, Sq, Hk, Dh), (Bq, Sq, Hk, Dh),
        (Bq, Sq, Hq, Dh)))
    pos = np.arange(Sq, dtype=np.int32)

    def jf(q, k, v):
        o = j_layers.flash_attention(q, k, v, jnp.asarray(pos),
                                     jnp.asarray(pos), causal=causal,
                                     window=W, q_chunk=qc, kv_chunk=kc,
                                     ctx=CTX)
        return jnp.sum(o * do), o

    (_, jo), jg = jax.value_and_grad(jf, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x.copy()).requires_grad_(True)
                  for x in (q, k, v))
    tpos = torch.from_numpy(pos)
    to = t_layers.flash_attention(tq, tk, tv, tpos, tpos, causal=causal,
                                  window=W, q_chunk=qc, kv_chunk=kc)
    (to * torch.from_numpy(do)).sum().backward()
    _close(to.detach().numpy(), jo)
    for t, j in zip((tq, tk, tv), jg):
        _close(t.grad.numpy(), j)


def test_flash_without_grad_is_the_forward():
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.normal(size=(1, 40, 4, 8)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(1, 40, 2, 8)).astype(np.float32))
    pos = torch.arange(40)
    with torch.no_grad():
        a = t_layers.flash_attention(q, k, k, pos, pos, q_chunk=16,
                                     kv_chunk=16)
    b = t_layers.flash_attention(q.requires_grad_(True), k, k, pos, pos,
                                 q_chunk=16, kv_chunk=16)
    assert b.requires_grad and torch.equal(a, b.detach())


def test_lm_loss_chunked_against_reference():
    cfg = dataclasses.replace(j_get_config("qwen2-1.5b", reduced=True),
                              loss_chunk=16)
    rng = np.random.default_rng(6)
    Bq, Sq, D, V = 2, 64, cfg.d_model, cfg.vocab
    h = rng.normal(size=(Bq, Sq, D)).astype(np.float32)
    head = (rng.normal(size=(V, D)) / np.sqrt(D)).astype(np.float32)
    labels = rng.integers(0, V, (Bq, Sq)).astype(np.int32)
    mask = (rng.random((Bq, Sq)) < 0.8).astype(np.float32)

    def jl(h, head):
        return j_layers.lm_loss_chunked(h, {"embed": head},
                                        jnp.asarray(labels),
                                        jnp.asarray(mask), cfg, CTX)

    jv, (jdh, jdw) = jax.value_and_grad(jl, argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(head))
    th = torch.from_numpy(h.copy()).requires_grad_(True)
    tw = torch.from_numpy(head.copy()).requires_grad_(True)
    tv = t_layers.lm_loss_chunked(th, {"embed": tw},
                                  torch.from_numpy(labels),
                                  torch.from_numpy(mask), cfg)
    tv.backward()
    _close(tv.item(), float(jv))
    _close(th.grad.numpy(), jdh)
    _close(tw.grad.numpy(), jdw)


# ---------------------------------------------------------------------------
# train_loss, dense and ssm
# ---------------------------------------------------------------------------

def _tokens(cfg, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S + 1), dtype=np.int32)
    batch = {"tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy()}
    if cfg.family == "audio":
        batch["frames"] = rng.normal(
            0, 1, (B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return batch


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _grads_against_reference(jcfg, params, batch):
    ops = j_get_model(jcfg)
    jv, jg = jax.value_and_grad(ops.train_loss)(
        jax.tree_util.tree_map(jnp.asarray, params),
        {k: jnp.asarray(v) for k, v in batch.items()}, jcfg, CTX)
    cfg = get_config(jcfg.name, reduced=True)
    cfg = dataclasses.replace(cfg, n_layers=jcfg.n_layers,
                              attn_every=jcfg.attn_every)
    from repro_torch.training.step import loss_and_grad
    tv, tg = loss_and_grad(get_model(cfg), cfg, from_numpy_tree(params, "cpu"),
                           from_numpy_tree(batch, "cpu"))
    _close(tv.item(), float(jv))
    for t, j in zip(tree_leaves(tg), jax.tree_util.tree_leaves(jg)):
        assert t.shape == j.shape
        assert _rel_l2(t.numpy(), j) <= 1e-4


@pytest.mark.parametrize("name", ARCHS)
def test_train_loss_and_grads_against_reference(name):
    jcfg, params = _ref_params(name)
    _grads_against_reference(jcfg, params, _tokens(jcfg))


def test_hybrid_shared_block_applied_twice_against_reference():
    """zamba2-1.2b with 4 Mamba2 layers and the shared block after every
    2: two applications of one set of shared weights (the reduced config
    has one), whose gradient is the sum over both, held to
    ``jax.grad`` of the reference at 1e-4 relative L2 per leaf."""
    jcfg = dataclasses.replace(j_get_config("zamba2-1.2b", reduced=True),
                               n_layers=4, attn_every=2)
    params = _np(j_get_model(jcfg).init_params(jax.random.PRNGKey(5), jcfg))
    _grads_against_reference(jcfg, params, _tokens(jcfg, seed=5))


@pytest.mark.parametrize("name", ARCHS)
def test_remat_is_bit_exact(name):
    from repro_torch.training.step import loss_and_grad
    _, params = _ref_params(name, seed=3)
    cfg = get_config(name, reduced=True)
    batch = from_numpy_tree(_tokens(cfg, seed=2), "cpu")
    out = []
    for remat in (True, False):
        c = dataclasses.replace(cfg, remat=remat)
        out.append(loss_and_grad(get_model(c), c,
                                 from_numpy_tree(params, "cpu"), batch))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(out[0][1]),
                                                 tree_leaves(out[1][1])))


@pytest.mark.parametrize("name", ARCHS)
def test_per_layer_leaves_give_the_same_loss(name):
    """``split_layers`` holds each layer's weights as leaves of their own,
    for every stacked subtree of the family (``layers``; the
    encoder-decoder's ``enc_layers`` and ``dec_layers``), and keeps every
    other leaf (the hybrid's ``shared`` block) as it is, except that every
    attention's ``wo`` is held 2-D, ``(Hq·Dh, D)``; the forward and the
    gradients, reshaped to the stacked leaves' shapes, are the stacked
    tree's bit for bit."""
    from repro_torch.training.step import loss_and_grad
    from repro_torch.utils.tree import flatten_with_path, keystr
    _, params = _ref_params(name, seed=4)
    cfg = get_config(name, reduced=True)
    batch = from_numpy_tree(_tokens(cfg, seed=3), "cpu")
    stacked = from_numpy_tree(params, "cpu")
    ops = get_model(cfg)
    want_keys = {"audio": ["enc_layers", "dec_layers"]}.get(cfg.family,
                                                             ["layers"])
    assert [k for k, _ in ops.stacked_layers] == want_keys
    split = t_layers.split_layers(stacked, ops.stacked_layers)
    for key, n in ops.stacked_layers:
        assert isinstance(split[key], list) and len(split[key]) == n
    wo = [x for p, x in flatten_with_path(split)[0]
          if keystr(p).endswith("['wo']")]
    assert bool(wo) == cfg.has_attention
    assert all(x.dim() == 2 for x in wo)
    for key in set(stacked) - set(want_keys):
        for a, b in zip(tree_leaves(stacked[key]), tree_leaves(split[key])):
            assert b is a or (b.dim() == 2 and torch.equal(a.reshape(b.shape),
                                                           b))
    l0, g0 = loss_and_grad(ops, cfg, stacked, batch)
    l1, g1 = loss_and_grad(ops, cfg, split, batch)
    assert torch.equal(l0, l1)
    for key, n in ops.stacked_layers:
        for i in range(n):
            per = tree_leaves(g1[key][i])
            for a, b in zip(tree_leaves(g0[key]), per):
                assert torch.equal(a[i].reshape(b.shape), b)
    for key in set(stacked) - set(want_keys):
        assert all(torch.equal(a.reshape(b.shape), b) for a, b in zip(
            tree_leaves(g0[key]), tree_leaves(g1[key])))


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_dataset_tokens_equal_reference(seed):
    jcfg = j_get_config("qwen2-1.5b", reduced=True)
    cfg = get_config("qwen2-1.5b", reduced=True)
    jd = JDataset(jcfg, B, S, CTX, seed=seed)
    td = ShardedLMDataset(cfg, B, S, seed=seed, device="cpu")
    for _ in range(3):
        jb, tb = jd.next_batch(), td.next_batch()
        for k in ("tokens", "labels"):
            assert tb[k].dtype == torch.int32
            assert np.array_equal(tb[k].numpy(), np.asarray(jb[k]))


def test_dataset_frames_equal_reference():
    """The encoder-decoder's batches: ``frames`` drawn after the tokens
    from the same generator, f32, equal to the reference's; the train
    step's microbatches split them along dim 0 with the tokens."""
    from repro_torch.training.step import _microbatches
    jcfg = j_get_config("whisper-medium", reduced=True)
    cfg = get_config("whisper-medium", reduced=True)
    jd = JDataset(jcfg, 4, S, CTX, seed=2)
    td = ShardedLMDataset(cfg, 4, S, seed=2, device="cpu")
    for _ in range(2):
        jb, tb = jd.next_batch(), td.next_batch()
        assert set(tb) == set(jb) == {"tokens", "labels", "frames"}
        assert tb["frames"].dtype == torch.float32
        assert tb["frames"].shape == (4, cfg.enc_seq, cfg.d_model)
        for k in jb:
            assert np.array_equal(tb[k].numpy(), np.asarray(jb[k]))
    mbs = _microbatches(tb, 2)
    for i, mb in enumerate(mbs):
        for k in tb:
            assert torch.equal(mb[k], tb[k][2 * i:2 * i + 2])


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

def _loop(name, arena_state=True, **kw):
    cfg = get_config(name, reduced=True)
    pol = kw.pop("policy", CheckpointPolicy.scar(fraction=0.25, interval=2))
    loop = TrainLoop(cfg, loop_cfg=TrainLoopConfig(
        policy=pol, fabric=kw.pop("fabric", FabricConfig()),
        arena_state=arena_state, **kw), device="cpu")
    return loop, loop.init_state(), ShardedLMDataset(cfg, B, S,
                                                      device="cpu")


@pytest.mark.parametrize("name", ARCHS)
def test_arena_and_pytree_paths_bit_identical(name):
    la, sa, da = _loop(name, True)
    lt, st, dt = _loop(name, False)
    assert isinstance(sa, ArenaTrainState) and isinstance(st, TrainState)
    sa = la.run(sa, iter(da), 6)
    st = lt.run(st, iter(dt), 6)
    assert [m["loss"] for m in la.metrics] == [m["loss"] for m in lt.metrics]
    assert torch.equal(la.controller._ckpt_arena, lt.controller._ckpt_arena)
    assert torch.equal(la.controller.ckpt.saved_iter,
                       lt.controller.ckpt.saved_iter)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(sa.params),
                                                 tree_leaves(st.params)))
    fab = la.controller.fabric
    assert fab.stats["arena_resident_maintains"] \
        == fab.stats["arena_maintains"] == 6
    assert lt.controller.fabric.stats["arena_resident_maintains"] == 0


@pytest.mark.parametrize("name", ARCHS)
def test_trainer_against_reference(name):
    """Losses over 6 steps within rtol 1e-4; a host loss at step 5 (hosts
    0 and 2 together: PEER_REPLICA, PARITY and RUNNING_CKPT) recovers with
    the reference's tier counts, and ``saved_iter`` is equal."""
    sched = [(5, "host", 0), (5, "host", 2)]
    jcfg = j_get_config(name, reduced=True)
    jl = JLoop(jcfg, CTX, loop_cfg=JLoopConfig(
        policy=JPolicy.scar(fraction=0.25, interval=2), fabric=JFabric(),
        fail_schedule=sched))
    js = jl.init_state()
    params = _np(js.params)
    jl.run(js, iter(JDataset(jcfg, B, S, CTX)), 6)
    cfg = get_config(name, reduced=True)
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
    assert len(tf["tier_fallbacks"]) == len(jf["tier_fallbacks"])


def test_arena_failure_recovers_via_peer_replica():
    """A uniform loss on the arena path: every lost block comes back from
    PEER_REPLICA at zero perturbation, and training goes on
    arena-resident."""
    loop, state, ds = _loop("qwen2-1.5b", True)
    it = iter(ds)
    state = loop.run(state, it, 3)
    state, info = loop.inject_failure(state, 0.5)
    assert isinstance(state, ArenaTrainState)
    tiers = info["tier_counts"]
    assert tiers["PEER_REPLICA"] == info["lost_blocks"] > 0
    assert tiers["RUNNING_CKPT"] == tiers["DISK"] == tiers["PARITY"] == 0
    assert info["applied_sq"] <= 1e-9
    state = loop.run(state, it, 3)
    assert all(np.isfinite(m["loss"]) for m in loop.metrics)


@pytest.mark.parametrize("arena", [True, False])
def test_microbatched_step_matches_single(arena):
    """``cfg.microbatch = 2`` gives the same loss and update as 1 (the
    reference's test, on both of the port's step forms)."""
    _, params = _ref_params("qwen2-1.5b")
    cfg = get_config("qwen2-1.5b", reduced=True)
    cfg_mb = dataclasses.replace(cfg, microbatch=2)
    ops = get_model(cfg)
    tp = from_numpy_tree(params, "cpu")
    layout = t_arena.build_arena_layout(partition_pytree(tp, 128))
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, (4, S + 1), dtype=np.int32)
    batch = from_numpy_tree({"tokens": toks[:, :-1].copy(),
                             "labels": toks[:, 1:].copy()}, "cpu")
    opt = t_opt.sgd(0.1)
    out = []
    for c in (cfg, cfg_mb):
        if arena:
            s0 = ArenaTrainState.create(t_arena.pack_arena(tp, layout), opt,
                                        layout)
            s1, loss = make_arena_train_step(ops, c, opt, layout)(s0, batch)
            out.append((loss, s1.arena.view(torch.float32)))
        else:
            s0 = TrainState.create(tree_map(torch.clone, tp), opt)
            s1, loss = make_train_step(ops, c, opt)(s0, batch)
            out.append((loss, t_arena.pack_arena(s1.params, layout)
                        .view(torch.float32)))
    assert out[0][0].item() == pytest.approx(out[1][0].item(), rel=1e-5)
    np.testing.assert_allclose(out[0][1].numpy(), out[1][1].numpy(),
                               rtol=1e-4, atol=1e-5)


def test_microbatched_arena_steps_clear_their_accumulator():
    """One arena step function run four times with ``microbatch = 2``
    (its accumulator cleared and reused at each step, released before the
    last) gives the PyTree step's losses and parameters bit for bit at
    every step."""
    _, params = _ref_params("qwen2-1.5b")
    cfg = dataclasses.replace(get_config("qwen2-1.5b", reduced=True),
                              microbatch=2)
    ops = get_model(cfg)
    tp = from_numpy_tree(params, "cpu")
    layout = t_arena.build_arena_layout(partition_pytree(tp, 128))
    opt = t_opt.adamw(1e-2)
    sa = ArenaTrainState.create(t_arena.pack_arena(tp, layout), opt, layout)
    st = TrainState.create(tree_map(torch.clone, tp), opt)
    arena_step = make_arena_train_step(ops, cfg, opt, layout)
    tree_step = make_train_step(ops, cfg, opt)
    rng = np.random.default_rng(2)
    for i in range(4):
        if i == 3:
            arena_step.release()
        toks = rng.integers(0, cfg.vocab, (4, S + 1), dtype=np.int32)
        batch = from_numpy_tree({"tokens": toks[:, :-1].copy(),
                                 "labels": toks[:, 1:].copy()}, "cpu")
        sa, la = arena_step(sa, batch)
        st, lt = tree_step(st, batch)
        assert torch.equal(la, lt)
        assert torch.equal(sa.arena, t_arena.pack_arena(st.params, layout))


def test_arena_state_params_view_follows_in_place_updates():
    loop, state, ds = _loop("qwen2-1.5b", True)
    before = [x.clone() for x in tree_leaves(state.params)]
    assert state.params is state.params            # cached
    state = loop.run(state, iter(ds), 1)            # updates in place
    after = tree_leaves(state.params)
    assert not all(torch.equal(a, b) for a, b in zip(before, after))
    assert torch.equal(t_arena.pack_arena(state.params, state.layout),
                       state.arena)


def test_soak_schedule_heal_and_summaries():
    """A scheduled host loss on an elastic fabric heals two steps later;
    the availability and overhead summaries count the clean steps."""
    loop, state, ds = _loop("qwen2-1.5b", True,
                            fabric=FabricConfig(elastic=True),
                            fail_schedule=[(2, "host", 1)], heal_after=2)
    state = loop.run(state, iter(ds), 6)
    steps_with = {m["step"]: m for m in loop.metrics}
    assert "failures" in steps_with[2] and "heals" in steps_with[4]
    assert steps_with[2]["failures"][0]["placement"]["rehomed_blocks"] > 0
    summ = loop.overhead_summary()
    assert summ["overhead_clean_steps"] == 4 and summ["arena_state"]
    assert summ["overlap_efficiency"] == 0.0
    assert set(summ["phases"]) == {"sweep", "save", "fence"}
    avail = loop.availability_summary()
    assert avail["n_events"] == 1 and avail["steps"] == 6


def test_flip_schedule_and_scrub_on_rs_fabric():
    """A bit flip in the replica arena is found and corrected by the RS
    fabric's scrub at the next scrub step."""
    loop, state, ds = _loop(
        "qwen2-1.5b", True,
        fabric=FabricConfig(n_devices=8, devices_per_host=1,
                            hosts_per_rack=4, rs_parity=2),
        flip_schedule=[(3, 0)], scrub_interval=3)
    loop.run(state, iter(ds), 4)
    m3 = loop.metrics[2]
    assert m3["bit_flips"][0]["block"] == 0
    assert m3["scrub"] == {"detected": 1, "corrected": 1}


def test_fail_prob_draws_like_the_reference():
    """``fail_prob`` draws its failure steps from the loop's
    ``default_rng(seed)``, as the reference does."""
    loop, state, ds = _loop("mamba2-370m", True, fail_prob=0.5,
                            fail_domain="host", seed=7)
    loop.run(state, iter(ds), 5)
    rng = np.random.default_rng(7)
    want = [rng.random() < 0.5 for _ in range(5)]
    got = ["failure" in m for m in loop.metrics]
    assert got == want and any(got)


def test_mtbf_trace_equals_reference():
    """A soak's MTBF-sampled schedule comes from the loop's
    ``default_rng(seed)`` through the fabric's domain map, as in the
    reference: the same events at the same steps."""
    mtbf = {"host": 5.0, "device": 3.0}
    jcfg = j_get_config("mamba2-370m", reduced=True)
    jl = JLoop(jcfg, CTX, loop_cfg=JLoopConfig(
        policy=JPolicy.scar(fraction=0.25, interval=2), fabric=JFabric(),
        mtbf=mtbf, seed=5))
    jl.init_state()
    loop, _, _ = _loop("mamba2-370m", True, mtbf=mtbf, seed=5)
    want = {k: [(e.step, e.kind, e.index) for e in v]
            for k, v in jl._sample_trace(20).items()}
    got = {k: [(e.step, e.kind, e.index) for e in v]
           for k, v in loop._sample_trace(20).items()}
    assert got == want and got
