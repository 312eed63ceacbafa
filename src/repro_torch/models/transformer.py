"""Decoder-only transformer LM: the dense, MoE and VLM families.

The port of ``repro.models.transformer`` for one device: prefill and
single-token decode with a KV cache, linear for full-attention decode or a
ring buffer of ``sliding_window`` slots for the sub-quadratic long-context
variant.

Prefill attention on the card is the ``sw_attention`` CUDA kernel, the
TPU kernel that the reference's ``models/layers.py`` names for its
attention: with ``window=S`` for causal attention (the band ``qpos - kpos
< S`` holds for every causal pair), with the config's window for a ring
prefill. On the CPU it is the plain chunked ``layers.flash_attention``.
Decode attention reads the cache (one query, ``kpos = -1`` holes in a
ring) and stays the plain ``flash_attention`` on every device, as in the
reference: no TPU kernel covers it.

Training (``train_loss``) is the reference's: full causal attention
through ``layers.flash_attention``'s flash-style backward on every device
(the reference trains without a kernel too), unless ``window_override``
asks for a band, each layer recomputed in backward when ``cfg.remat``
(an MoE layer's aux losses with it), the chunked LM loss over the tokens
(a VLM's patch prefix takes none) and an MoE model's router losses.

Layers are stacked along a leading ``n_layers`` dim, as in the reference,
and walked by a Python loop. An MoE layer (qwen3-moe) replaces the MLP by
``layers.moe_block``; an interleaved model (llama4-maverick,
``moe_every=2``) stacks ``layers = {"dense": ..., "moe": ...}`` over its
``n_layers // 2`` pairs and walks each pair dense then MoE, its cache
stacking ``[dense_i, moe_i]`` (cache layer ``2 i`` is pair ``i``'s dense
layer); a VLM (internvl2) projects the batch's ``patches`` and prepends
them to the token embeddings, so its prompt is ``S + n_patches`` long.
Every reader of the weights takes the trainer's per-layer layout too
(``layers.split_layers``: ``wo`` and the expert stacks held 2-D).
``train_loss`` takes a ``ctx``: on a mesh with a ``model`` axis of more
than one position it runs the tensor- and expert-parallel forward over
this rank's weight slices (``layers``; ``params`` holds the slices that
``sharding.partition.take_model_slices`` cut; the embedding and the head
whole where the vocab does not split, ``partition.vocab_ctx``) and the
rank's data shard. ``init_cache``, ``prefill`` and ``decode_step`` take
the same ``ctx``: each rank serves its data shard over its heads (the
sw_attention kernel on the card over ``Hq / tp`` query heads and the kv
heads they read: ``Hk / tp``, or one kv head that the ranks whose query
heads read it share), its cache holds those kv heads
(``partition.state_slices``) and the logits are the whole vocab's on
every rank. ``decode_step`` writes
the new token's K/V into the cache in place.

The perf variants, as the reference's: under ``cfg.kv_quant`` the cache
holds int8 ``k``/``v`` with f32 ``k_scale``/``v_scale`` per (token, kv
head); the prefill quantizes each layer's kept K/V (in the model dtype) as
it writes them, and a decode step quantizes the new token's and attends
with ``layers.flash_attention_kvq``. ``cfg.triangle_prefill`` is accepted
and changes nothing: every causal prefill already skips the tiles above
the diagonal, the sw_attention kernel on the card and
``layers.flash_attention_triangle`` on the CPU (:func:`prefill_attention`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.collectives import model_axis
from repro_torch.kernels.sw_attention.ops import sw_attention
from repro_torch.models import layers as L
from repro_torch.sharding.partition import (batch_rows, check_tensor_parallel,
                                            kv_head_range, vocab_ctx)

PyTree = Any


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return L.torch_dtype(cfg.dtype)


def interleaved(cfg: ModelConfig) -> bool:
    """llama4-style: dense and MoE layers alternate (``moe_every=2``)."""
    return bool(cfg.n_experts) and cfg.moe_every > 1


def init_layer(gen: torch.Generator, cfg: ModelConfig, device=None,
               layers: tuple = (), *, moe: Optional[bool] = None) -> PyTree:
    """One layer's weights, each leaf stacked over ``layers``: an MoE block
    where ``moe`` (default: the config has experts), else an MLP of
    ``d_ff_dense`` (an interleaved model's dense layers) or ``d_ff``."""
    dt = _dtype(cfg)
    dev = device if device is not None else gen.device
    Ls = tuple(layers)
    use_moe = bool(cfg.n_experts) if moe is None else moe
    p = {
        "attn_norm": torch.ones(Ls + (cfg.d_model,), dtype=dt, device=dev),
        "attn": L.init_attention(gen, cfg, dt, dev, Ls),
        "mlp_norm": torch.ones(Ls + (cfg.d_model,), dtype=dt, device=dev),
    }
    if use_moe:
        p["moe"] = L.init_moe(gen, cfg, dt, dev, Ls)
    else:
        p["mlp"] = L.init_mlp(gen, cfg.d_model, cfg.d_ff_dense or cfg.d_ff,
                              dt, dev, Ls)
    return p


def init_params(gen: torch.Generator, cfg: ModelConfig,
                device: DeviceLike = None) -> PyTree:
    """Random weights from ``gen`` (drawn on its device), placed on
    ``device`` (``cuda`` unless asked otherwise), layers stacked: over
    ``n_layers``, or for an interleaved model ``{"dense", "moe"}`` each
    over the ``n_layers // 2`` pairs. A VLM adds ``projector.proj`` of
    ``(vit_dim, d_model)``."""
    dev = resolve_device(device)
    dt = _dtype(cfg)
    if interleaved(cfg):
        n_pairs = cfg.n_layers // 2
        layers = {"dense": init_layer(gen, cfg, dev, (n_pairs,), moe=False),
                  "moe": init_layer(gen, cfg, dev, (n_pairs,), moe=True)}
    else:
        layers = init_layer(gen, cfg, dev, (cfg.n_layers,))
    p = {
        **L.init_embed(gen, cfg, dt, dev),
        "layers": layers,
        "final_norm": torch.ones((cfg.d_model,), dtype=dt, device=dev),
    }
    if cfg.family == "vlm":
        p["projector"] = {"proj": L.dense_init(
            gen, (cfg.vit_dim, cfg.d_model), cfg.vit_dim, dt, dev)}
    return p


def layer_walk(params: PyTree, cfg: ModelConfig):
    """Each layer's weights in the order the model runs them, with its
    index in the cache: layer ``i``; for an interleaved model pair ``i``'s
    dense layer at ``2 i`` and its MoE layer at ``2 i + 1``. Stacked leaves
    are walked as ``torch.unbind`` views (:func:`layers.unstack_layers`),
    whose backward stacks the layers' gradients once."""
    if not interleaved(cfg):
        yield from enumerate(L.unstack_layers(params["layers"],
                                              cfg.n_layers))
        return
    for i, pair in enumerate(L.unstack_layers(params["layers"],
                                              cfg.n_layers // 2)):
        yield 2 * i, pair["dense"]
        yield 2 * i + 1, pair["moe"]


def _ffn(x, lp, cfg: ModelConfig, ctx=None, seq=None):
    """The layer's MLP or MoE block on its normed input (``seq``, the
    stack's ``layers.seq_axis``: x is the rank's piece of a
    sequence-parallel carry), and the MoE block's ``(lb_loss, z_loss)``
    (zeros for an MLP)."""
    hn = L.carry_norm(x, lp, "mlp_norm", ctx, seq)
    if "moe" in lp:
        return L.moe_block(hn, lp["moe"], cfg, ctx=ctx, seq=seq)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    return L.mlp_block(hn, lp["mlp"], ctx, seq), (zero, zero)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _layer_fwd(x, lp, cfg: ModelConfig, positions, window: int,
               q_chunk: int, kv_chunk: int, ctx=None, seq=None):
    """One layer -> (x', lb_loss, z_loss); ``seq``: x is the rank's piece
    of a sequence-parallel carry (``positions`` the whole S's)."""
    h = L.attention_block(L.carry_norm(x, lp, "attn_norm", ctx, seq),
                          lp["attn"], cfg, positions=positions, causal=True,
                          window=window, q_chunk=q_chunk, kv_chunk=kv_chunk,
                          ctx=ctx, seq=seq)
    x = x + h
    h2, (lb, zl) = _ffn(x, lp, cfg, ctx, seq)
    return x + h2, lb, zl


def _stack_fwd(h, params, cfg: ModelConfig, positions, *, window: int,
               q_chunk: int = 1024, kv_chunk: int = 1024, ctx=None,
               seq=None):
    """Every layer in the order :func:`layer_walk` gives (an interleaved
    model's dense then MoE layer of each pair), each recomputed in
    backward when ``cfg.remat``, its aux losses with it; then the final
    norm. ``seq`` (``layers.seq_axis``): the carry ``h`` is the rank's
    piece of S (its saved remat input too). Returns (h, Σ lb_loss, Σ z_loss)."""
    lb = zl = torch.zeros((), dtype=torch.float32, device=h.device)
    for _, lp in layer_walk(params, cfg):
        h, l1, l2 = L.layer_call(lambda x, lp: _layer_fwd(
            x, lp, cfg, positions, window, q_chunk, kv_chunk, ctx, seq),
            h, lp, enabled=cfg.remat)
        lb, zl = lb + l1, zl + l2
    return L.carry_norm(h, params, "final_norm", ctx, seq), lb, zl


def _embed_batch(params, batch, cfg: ModelConfig, ctx=None, seq=None):
    """Token embeddings, after a VLM's projected patch prefix when the
    batch has ``patches`` -> (B, S_total, D); ``ctx`` the vocab's. Where
    ``seq`` (the train stack's :func:`layers.seq_axis`), the rank's piece
    of S_total: the tokens' reduce-scattered from the vocab blocks
    (:func:`layers.embed_carry`), or with a prefix the whole sequence
    split, the prefix computed whole (its gradient whole on every
    rank)."""
    if not (cfg.family == "vlm" and "patches" in batch):
        return L.embed_carry(batch["tokens"], params, ctx, seq)
    tok = L.embed_tokens(batch["tokens"], params, ctx)
    prefix = torch.einsum("bpv,vd->bpd", batch["patches"].to(_dtype(cfg)),
                          params["projector"]["proj"])
    tok = torch.cat([prefix, tok], dim=1)
    return tok if seq is None else seq.split(tok)


def _train_seq(batch, cfg: ModelConfig) -> int:
    """The positions of a train batch's sequence: its tokens and a VLM's
    patch prefix."""
    S = batch["tokens"].shape[1]
    if cfg.family == "vlm" and "patches" in batch:
        S += batch["patches"].shape[1]
    return S


def train_loss(params, batch, cfg: ModelConfig, *,
               window_override: Optional[int] = None,
               ctx=None) -> torch.Tensor:
    """Mean next-token cross-entropy of ``batch`` (``tokens``, ``labels``
    and an optional ``mask``; a VLM's ``patches``), f32. Full causal
    attention unless ``window_override`` gives a band. A VLM's patch
    prefix takes no loss; an MoE model adds its router losses, ``0.01
    Σ lb_loss / n_layers + 0.001 Σ z_loss / n_layers`` over every layer
    (an interleaved model's dense layers count in ``n_layers`` and add
    zeros), as the reference.

    With ``ctx`` on a mesh whose ``model`` axis has ``tp > 1`` positions,
    ``params`` are this rank's model slices and ``batch`` its data shard:
    the loss is the data shard's, the same on every rank of its model
    line (raises ``ValueError`` where the config does not split over
    ``tp``). Where ``tp`` divides the sequence (a VLM's prefix included)
    the carry between layers is the rank's piece of it
    (:func:`layers.seq_axis`, Megatron SP), gathered for the loss."""
    if ctx is not None:
        check_tensor_parallel(cfg, ctx.tp_size)
    vctx = vocab_ctx(cfg, ctx)
    S = _train_seq(batch, cfg)
    seq = L.seq_axis(ctx, S)
    h = _embed_batch(params, batch, cfg, vctx, seq)
    positions = torch.arange(S, dtype=torch.int32, device=h.device)
    window = 0 if window_override is None else window_override
    h, lb, zl = _stack_fwd(h, params, cfg, positions, window=window,
                           q_chunk=cfg.attn_chunk, kv_chunk=cfg.attn_chunk,
                           ctx=ctx, seq=seq)
    labels, mask = batch["labels"], L.loss_mask(batch)
    if seq is not None:
        # the loss gathers the pieces, then drops a VLM's image prefix
        loss = L.lm_loss_chunked(h, params, labels, mask, cfg, ctx=vctx,
                                 seq=seq)
    else:
        n_prefix = h.shape[1] - labels.shape[1]
        if n_prefix:        # a VLM: no loss on the image prefix
            h = h[:, n_prefix:]
        if vctx is None:    # the one-device call, as before the mesh's
            loss = L.lm_loss_chunked(h, params, labels, mask, cfg)
        else:
            loss = L.lm_loss_chunked(h, params, labels, mask, cfg, ctx=vctx)
    if cfg.n_experts:
        loss = loss + 0.01 * lb / cfg.n_layers + 0.001 * zl / cfg.n_layers
    return loss


# ---------------------------------------------------------------------------
# serving: prefill + single-token decode with KV cache
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CacheSpec:
    cache_len: int      # slots (== window for ring-buffer archs)
    ring: bool


def cache_spec(cfg: ModelConfig, seq_len: int, *, use_window: bool
               ) -> CacheSpec:
    if use_window and cfg.sliding_window and seq_len > cfg.sliding_window:
        return CacheSpec(cache_len=cfg.sliding_window, ring=True)
    return CacheSpec(cache_len=seq_len, ring=False)


def _kv_heads(cfg: ModelConfig, ctx=None) -> int:
    """The kv heads a rank holds: all of them, or on a model axis those
    its own query heads read (``partition.kv_head_range``: ``n_kv_heads /
    tp``, one that ranks share, or none on a rank without query heads;
    raises ``ValueError`` where the config does not split over ``ctx``'s
    model axis)."""
    if ctx is None:
        return cfg.n_kv_heads
    check_tensor_parallel(cfg, ctx.tp_size)
    if ctx.tp_size == 1:
        return cfg.n_kv_heads
    lo, hi = kv_head_range(cfg.n_heads, cfg.n_kv_heads, ctx.tp_size,
                           ctx.mesh.axis_position(ctx.tp))
    return hi - lo


def init_cache(params_or_none, cfg: ModelConfig, batch: int, spec: CacheSpec,
               device: DeviceLike = None, ctx=None) -> PyTree:
    """An empty cache on ``device`` (``cuda`` unless asked otherwise):
    ``k``/``v`` (L, B, cache_len, Hk, Dh) in the model dtype, or int8 with
    zero f32 ``k_scale``/``v_scale`` (L, B, cache_len, Hk) under
    ``cfg.kv_quant``. With ``ctx`` on a mesh, this rank's slice of it
    (``sharding.partition.state_slices``): its data shard of the ``batch``
    rows and its kv heads."""
    dev = resolve_device(device)
    heads = _kv_heads(cfg, ctx)
    lo, hi = batch_rows(batch, ctx)
    shape = (cfg.n_layers, hi - lo, spec.cache_len, heads, cfg.head_dim)
    dt = torch.int8 if cfg.kv_quant else _dtype(cfg)
    cache = {
        "k": torch.zeros(shape, dtype=dt, device=dev),
        "v": torch.zeros(shape, dtype=dt, device=dev),
        "kpos": torch.full((spec.cache_len,), -1, dtype=torch.int32,
                           device=dev),
        "pos": torch.zeros((), dtype=torch.int32, device=dev),
    }
    if cfg.kv_quant:
        cache["k_scale"] = torch.zeros(shape[:-1], dtype=torch.float32,
                                       device=dev)
        cache["v_scale"] = torch.zeros(shape[:-1], dtype=torch.float32,
                                       device=dev)
    return cache


def prefill_attention(q, k, v, positions, cfg: ModelConfig, window: int):
    """Causal (``window=0``) or banded prefill attention over the prompt:
    the sw_attention kernel on the card, the plain chunked attention on
    the CPU and on meta tensors (the dry run's; no kernel runs there):
    ``layers.flash_attention_triangle`` for a causal prefill.

    ``cfg.triangle_prefill`` changes nothing here, on either device. The
    kernel with ``window=S`` already visits only the key tiles at or below
    the diagonal (``csrc/sw_attention.cu``), and so does the plain causal
    route: that skip is what the reference's triangle route buys over its
    visit-every-tile baseline, and a tile above the diagonal is all masked,
    so skipping it gives the same bits."""
    S = q.shape[1]
    if q.device.type in ("cpu", "meta"):
        chunk = min(cfg.attn_chunk, S)
        if not window:
            return L.flash_attention_triangle(q, k, v, positions, positions,
                                              q_chunk=chunk, kv_chunk=chunk)
        return L.flash_attention(q, k, v, positions, positions, causal=True,
                                 window=window, q_chunk=chunk,
                                 kv_chunk=chunk)
    return sw_attention(q, k, v, window=window or S)


def _attn_out(o, wo, ctx=None):
    """The attention output projection; on a model axis this rank's heads'
    partial, summed over the axis."""
    out = L.attn_out(o, wo)
    axis = model_axis(ctx)
    return out if axis is None else axis.reduce(out)


def decode_step(params, cache, tokens, cfg: ModelConfig, spec: CacheSpec,
                ctx=None):
    """One decode step. tokens: (B, 1) -> logits (B, 1, V) f32 and the
    cache, whose K/V (and, under ``cfg.kv_quant``, scales) and ``kpos``
    are updated in place. With ``ctx`` on a mesh whose ``model`` axis has
    more than one position, ``params`` are this rank's model slices,
    ``tokens`` and ``cache`` its data shard's (the cache over its kv
    heads): the attention runs over its heads and the MLP over its
    ``d_ff`` (the MoE over its experts at the shard's capacity), each
    output's partials summed over the axis, and the logits are the whole
    vocab's on every rank of the line."""
    vctx = vocab_ctx(cfg, ctx)
    x = L.embed_tokens(tokens, params, vctx)
    pos = int(cache["pos"])
    positions = torch.tensor([pos], dtype=torch.int32, device=x.device)
    slot = (pos % spec.cache_len) if spec.ring else pos
    kpos = cache["kpos"]
    kpos[slot] = pos
    window = cfg.sliding_window if spec.ring else 0
    kv_chunk = min(cfg.attn_chunk, spec.cache_len)
    for i, lp in layer_walk(params, cfg):
        kc, vc = cache["k"][i], cache["v"][i]
        xn = L.rms_norm(x, lp["attn_norm"])
        q, k, v = L.qkv_project(xn, lp["attn"], cfg, positions, ctx)
        if cfg.kv_quant:
            # the new token quantized as the reference does (its model-dtype
            # k/v), the cache streamed a chunk at a time in int8
            ksc, vsc = cache["k_scale"][i], cache["v_scale"][i]
            (k8, k_s), (v8, v_s) = L.quantize_kv(k), L.quantize_kv(v)
            kc[:, slot], ksc[:, slot] = k8[:, 0], k_s[:, 0]
            vc[:, slot], vsc[:, slot] = v8[:, 0], v_s[:, 0]
            o = L.flash_attention_kvq(q, kc, vc, ksc, vsc, positions, kpos,
                                      window=window, kv_chunk=kv_chunk)
        else:
            kc[:, slot] = k[:, 0].to(kc.dtype)
            vc[:, slot] = v[:, 0].to(vc.dtype)
            o = L.flash_attention(q, kc, vc, positions, kpos, causal=True,
                                  window=window, q_chunk=1,
                                  kv_chunk=kv_chunk)
        x = x + _attn_out(o, lp["attn"]["wo"], ctx)
        x = x + _ffn(x, lp, cfg, ctx)[0]
    h = L.rms_norm(x, params["final_norm"])
    logits = L.lm_logits(h, params, vctx)
    cache["pos"] = cache["pos"] + 1
    return logits, cache


def prefill(params, batch, cfg: ModelConfig, spec: CacheSpec, ctx=None):
    """Prefill over a full prompt (a VLM's patch prefix first); returns
    (logits of the last position (B, 1, V) f32, cache). Under
    ``cfg.kv_quant`` each layer's kept K/V are quantized as they are
    written, from the model-dtype values: the reference's quantization of
    the whole finished cache, bit for bit, without a model-dtype copy of
    the cache beside the int8 one. With ``ctx`` (see :func:`decode_step`)
    ``batch`` is this rank's data shard, the attention (the sw_attention
    kernel on the card) runs over its ``Hq / tp`` query heads and the kv
    heads they read, and the cache holds those kv heads."""
    vctx = vocab_ctx(cfg, ctx)
    x = _embed_batch(params, batch, cfg, vctx)
    B, S, _ = x.shape
    dt = _dtype(cfg)
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    window = cfg.sliding_window if (cfg.sliding_window and spec.ring) else 0
    shape = (cfg.n_layers, B, spec.cache_len, _kv_heads(cfg, ctx),
             cfg.head_dim)
    quant = cfg.kv_quant
    ks = torch.zeros(shape, dtype=torch.int8 if quant else dt,
                     device=x.device)
    vs = torch.zeros_like(ks)
    if quant:
        # every slot that holds no token gets quantize_kv's scale of a zero
        # row, 1e-8 / 127: the reference quantizes its whole cache
        empty = L.quantize_kv(torch.zeros((1, 1), device=x.device))[1]
        k_scale = empty.expand(shape[:-1]).clone()
        v_scale = k_scale.clone()
    if spec.ring:
        # place the last `cache_len` positions at their ring slots so that
        # later decode writes (slot = pos % cache_len) line up
        W = spec.cache_len
        slots = torch.arange(S - W, S, device=x.device) % W
    for i, lp in layer_walk(params, cfg):
        xn = L.rms_norm(x, lp["attn_norm"])
        q, k, v = L.qkv_project(xn, lp["attn"], cfg, positions, ctx)
        o = prefill_attention(q, k, v, positions, cfg, window)
        x = x + _attn_out(o, lp["attn"]["wo"], ctx)
        x = x + _ffn(x, lp, cfg, ctx)[0]
        kept = [k.to(dt), v.to(dt)]
        if quant:
            kept = [*L.quantize_kv(kept[0]), *L.quantize_kv(kept[1])]
            dsts = (ks[i], k_scale[i], vs[i], v_scale[i])
        else:
            dsts = (ks[i], vs[i])
        for dst, src in zip(dsts, kept):
            if spec.ring:
                dst[:, slots] = src[:, -W:]
            else:
                # slots past S stay empty: room for the tokens decoded next
                dst[:, :S] = src
    hfin = L.rms_norm(x, params["final_norm"])
    logits = L.lm_logits(hfin[:, -1:], params, vctx)
    kept = min(spec.cache_len, S)
    kept_positions = torch.arange(S - kept, S, dtype=torch.int32,
                                  device=x.device)
    kpos = torch.full((spec.cache_len,), -1, dtype=torch.int32,
                      device=x.device)
    kpos[kept_positions.long() % spec.cache_len] = kept_positions
    cache = {"k": ks, "v": vs, "kpos": kpos,
             "pos": torch.tensor(S, dtype=torch.int32, device=x.device)}
    if quant:
        cache["k_scale"], cache["v_scale"] = k_scale, v_scale
    return logits, cache
