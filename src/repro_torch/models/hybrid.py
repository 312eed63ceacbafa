"""Zamba2-style hybrid: a Mamba2 backbone and one *shared* attention block
[arXiv:2411.15242], serve path and training loss.

The port of ``repro.models.hybrid`` for one device. The backbone is
``n_layers`` Mamba2 layers; one transformer layer (GQA attention and MLP)
with a single set of weights is applied after every ``cfg.attn_every``
backbone layers, the last segment possibly shorter (``_segments``).

Prefill runs each Mamba2 layer through ``ssm.mixer_prefill`` (the
``ssd_intra`` kernel inside the SSD scan on the card) and each application
of the shared block through ``transformer.prefill_attention`` (the
``sw_attention`` kernel with ``window=S`` on the card, the plain chunked
attention on the CPU). The state holds the per-layer SSM states and one KV
cache per application of the shared block, each the prompt plus the
reference's 64 empty slots, with one shared ``kpos``. Decode is plain torch
on every device: the recurrent Mamba2 step per layer and, per application,
attention over its cache; it writes slot ``pos % cache_len`` (the cache
wraps past its slack, as the reference's does) in place.

Training (``train_loss``) runs the plain SSD scan and the plain chunked
attention (``_Flash``) on every device, each Mamba2 layer and each
application of the shared block rematerialized in backward, as in the
reference; the trainer (``training.TrainLoop``) takes its gradient. The
shared block's gradient is the sum over its applications.

Parameters keep the reference's tree: ``layers`` (the Mamba2 layers
stacked over ``n_layers``, or a list of per-layer trees from
``layers.split_layers``), ``shared`` (one transformer layer, never split),
``final_norm`` and the embedding. ``train_loss`` takes a ``ctx``: on a
mesh with a ``model`` axis of more than one position each rank runs the
Mamba2 layers over its SSD heads and the shared block over its heads and
``d_ff`` (``ssm.mixer_fwd``, ``transformer._layer_fwd``) on its data
shard. ``init_state``, ``prefill`` and ``decode_step`` take the same
``ctx``: the rank's data shard served over its SSD heads and the shared
block's heads and ``d_ff``, each application's cache over its kv heads.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as L
from repro_torch.models import ssm, transformer
from repro_torch.sharding.partition import (batch_rows, check_tensor_parallel,
                                            vocab_ctx)

PyTree = Any

SLACK = 64      # empty cache slots after the prompt, as in the reference


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return L.torch_dtype(cfg.dtype)


def n_segments(cfg: ModelConfig) -> int:
    return -(-cfg.n_layers // cfg.attn_every)


def _segments(cfg: ModelConfig) -> list:
    """(start, length) of each backbone segment, in order."""
    segs, start = [], 0
    while start < cfg.n_layers:
        ln = min(cfg.attn_every, cfg.n_layers - start)
        segs.append((start, ln))
        start += ln
    return segs


def init_params(gen: torch.Generator, cfg: ModelConfig,
                device: DeviceLike = None) -> PyTree:
    """Random weights from ``gen`` (drawn on its device), placed on
    ``device`` (``cuda`` unless asked otherwise), the Mamba2 layers
    stacked."""
    dev = resolve_device(device)
    return {
        **L.init_embed(gen, cfg, _dtype(cfg), dev),
        "layers": ssm.init_layer(gen, cfg, dev, (cfg.n_layers,)),
        "shared": transformer.init_layer(gen, cfg, dev),
        "final_norm": torch.ones((cfg.d_model,), dtype=_dtype(cfg),
                                 device=dev),
    }


def train_loss(params, batch, cfg: ModelConfig, *, ctx=None
               ) -> torch.Tensor:
    """Mean next-token cross-entropy of ``batch`` (``tokens``, ``labels``
    and an optional ``mask``), f32: the plain SSD scan and full causal
    attention, each layer and each application of the shared block
    recomputed in backward when ``cfg.remat``. With ``ctx`` on a mesh
    whose ``model`` axis has ``tp > 1`` positions, ``params`` are this
    rank's model slices (SSD heads, the shared block's heads and
    ``d_ff``, the vocab where it splits) and ``batch`` its data shard."""
    if ctx is not None:
        check_tensor_parallel(cfg, ctx.tp_size)
    vctx = vocab_ctx(cfg, ctx)
    h = L.embed_tokens(batch["tokens"], params, vctx)
    positions = torch.arange(h.shape[1], dtype=torch.int32, device=h.device)
    layers = L.unstack_layers(params["layers"], cfg.n_layers)
    shared = params["shared"]
    for start, length in _segments(cfg):
        for lp in layers[start:start + length]:
            h = h + L.layer_call(lambda x, lp: ssm.mixer_fwd(
                L.rms_norm(x, lp["norm"]), lp["mixer"], cfg, ctx), h, lp,
                enabled=cfg.remat)
        h = L.remat(lambda x: transformer._layer_fwd(
            x, shared, cfg, positions, 0, 1024, 1024, ctx)[0], h,
            enabled=cfg.remat)
    h = L.rms_norm(h, params["final_norm"])
    return L.lm_loss_chunked(h, params, batch["labels"], L.loss_mask(batch),
                             cfg, ctx=vctx)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def init_state(cfg: ModelConfig, batch: int, cache_len: int,
               device: DeviceLike = None, ctx=None) -> PyTree:
    """A zero state on ``device`` (``cuda`` unless asked otherwise); with
    ``ctx`` on a mesh this rank's slice (``partition.state_slices``): its
    data shard of the ``batch`` rows, its SSD heads' states and its kv
    heads of each application's cache."""
    dev = resolve_device(device)
    lo, hi = batch_rows(batch, ctx)
    shape = (n_segments(cfg), hi - lo, cache_len,
             transformer._kv_heads(cfg, ctx), cfg.head_dim)
    return {
        "ssm": ssm.init_state(cfg, batch, dev, ctx),
        # one KV cache per application of the shared block
        "k": torch.zeros(shape, dtype=_dtype(cfg), device=dev),
        "v": torch.zeros(shape, dtype=_dtype(cfg), device=dev),
        "kpos": torch.full((cache_len,), -1, dtype=torch.int32, device=dev),
        "pos": torch.zeros((), dtype=torch.int32, device=dev),
    }


def _shared_mlp(x, lp, ctx=None):
    return x + L.mlp_block(L.rms_norm(x, lp["mlp_norm"]), lp["mlp"], ctx)


def prefill(params, batch, cfg: ModelConfig, spec=None, ctx=None):
    """The chunked SSD scan over the prompt and the shared block's KV
    caches. The prompt's length must be a multiple of ``cfg.ssm_chunk``
    (or below it): the scan raises ``ValueError`` otherwise. Returns
    (logits of the last position (B, 1, V) f32, state). With ``ctx`` on a
    mesh whose ``model`` axis has more than one position, ``params`` are
    this rank's model slices and ``batch`` its data shard: the Mamba2
    layers run over its SSD heads, each application of the shared block
    over its heads and ``d_ff``, the caches hold its kv heads."""
    vctx = vocab_ctx(cfg, ctx)
    tokens = batch["tokens"]
    x = L.embed_tokens(tokens, params, vctx)
    B, S = tokens.shape
    dt = _dtype(cfg)
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    segs = _segments(cfg)
    shape = (len(segs), B, S + SLACK, transformer._kv_heads(cfg, ctx),
             cfg.head_dim)
    ks = torch.zeros(shape, dtype=dt, device=x.device)
    vs = torch.zeros(shape, dtype=dt, device=x.device)
    lp_sh = params["shared"]
    hs, convs = [], []
    for si, (start, length) in enumerate(segs):
        for i in range(start, start + length):
            x, h_fin, conv_state = ssm.mixer_prefill(
                x, L.layer_params(params, i), cfg, ctx)
            hs.append(h_fin)
            convs.append(conv_state)
        xn = L.rms_norm(x, lp_sh["attn_norm"])
        q, k, v = L.qkv_project(xn, lp_sh["attn"], cfg, positions, ctx)
        o = transformer.prefill_attention(q, k, v, positions, cfg, 0)
        x = x + transformer._attn_out(o, lp_sh["attn"]["wo"], ctx)
        x = _shared_mlp(x, lp_sh, ctx)
        # slots past S stay empty: room for the tokens decoded next
        ks[si, :, :S] = k.to(dt)
        vs[si, :, :S] = v.to(dt)
    hfin = L.rms_norm(x, params["final_norm"])
    logits = L.lm_logits(hfin[:, -1:], params, vctx)
    kpos = torch.full((S + SLACK,), -1, dtype=torch.int32, device=x.device)
    kpos[:S] = positions
    pos = torch.tensor(S, dtype=torch.int32, device=x.device)
    state = {"ssm": {"h": torch.stack(hs), "conv": torch.stack(convs),
                     "pos": pos.clone()},
             "k": ks, "v": vs, "kpos": kpos, "pos": pos}
    return logits, state


def decode_step(params, state, tokens, cfg: ModelConfig, spec=None,
                ctx=None):
    """One decode step. tokens: (B, 1) -> (logits (B, 1, V) f32, the new
    state). The shared block's K/V and ``kpos`` are written in place at
    slot ``pos % cache_len``; the SSM states are new tensors. With
    ``ctx``, as :func:`prefill`."""
    vctx = vocab_ctx(cfg, ctx)
    x = L.embed_tokens(tokens, params, vctx)
    pos = int(state["pos"])
    positions = torch.tensor([pos], dtype=torch.int32, device=x.device)
    cache_len = state["k"].shape[2]
    slot = pos % cache_len
    kpos = state["kpos"]
    kpos[slot] = pos
    kv_chunk = min(1024, cache_len)
    sst = state["ssm"]
    lp_sh = params["shared"]
    hs, convs = [], []
    for si, (start, length) in enumerate(_segments(cfg)):
        for i in range(start, start + length):
            lp = L.layer_params(params, i)
            out, new = ssm.mixer_decode(
                L.rms_norm(x, lp["norm"]), lp["mixer"],
                {"h": sst["h"][i], "conv": sst["conv"][i]}, cfg, ctx)
            x = x + out
            hs.append(new["h"])
            convs.append(new["conv"])
        kc, vc = state["k"][si], state["v"][si]
        xn = L.rms_norm(x, lp_sh["attn_norm"])
        q, k, v = L.qkv_project(xn, lp_sh["attn"], cfg, positions, ctx)
        kc[:, slot] = k[:, 0].to(kc.dtype)
        vc[:, slot] = v[:, 0].to(vc.dtype)
        o = L.flash_attention(q, kc, vc, positions, kpos, causal=True,
                              q_chunk=1, kv_chunk=kv_chunk)
        x = x + transformer._attn_out(o, lp_sh["attn"]["wo"], ctx)
        x = _shared_mlp(x, lp_sh, ctx)
    h = L.rms_norm(x, params["final_norm"])
    logits = L.lm_logits(h, params, vctx)
    new_state = {"ssm": {"h": torch.stack(hs), "conv": torch.stack(convs),
                         "pos": sst["pos"] + 1},
                 "k": state["k"], "v": state["v"], "kpos": kpos,
                 "pos": state["pos"] + 1}
    return logits, new_state
