"""Whisper-style encoder-decoder transformer [arXiv:2212.04356], serve path
and training loss.

The port of ``repro.models.encdec`` for one device. The mel-spectrogram and
conv feature extractor are a stub, as in the reference: the batch carries
precomputed frame embeddings ``frames`` (B, enc_seq, D), which a learned
projection maps into the encoder. Positions are sinusoidal (no RoPE:
``rope_theta`` is 0). Decoder layers have causal self-attention (cached),
cross-attention to the encoder output (its K/V computed once at prefill)
and an MLP.

Prefill encodes the frames, then runs the decoder over the prompt: its
causal self-attention goes through ``transformer.prefill_attention`` (the
``sw_attention`` kernel with ``window=S`` on the card, the plain chunked
attention on the CPU). The encoder's bidirectional attention and the
cross-attention have no kernel in either package: they are the plain
chunked ``layers.flash_attention`` on every device, with the reference's
chunks. The cache is linear: the prompt plus the reference's 64 empty
slots. Decode is plain torch on every device and writes slot ``pos`` in
place; past the last slot it raises (the reference clamps the write to
the last slot and drops the ``kpos`` update).

Training (``train_loss``) encodes the frames without rematerialization
(the reference's encoder is a scan with no checkpoint) and recomputes each
decoder layer in backward; the trainer (``training.TrainLoop``) takes its
gradient, with ``frames`` in every batch (``data.ShardedLMDataset``).

Parameters keep the reference's tree: ``frame_proj``, ``enc_layers`` and
``dec_layers`` (stacked, or lists of per-layer trees from
``layers.split_layers``), ``enc_norm``, ``final_norm`` and the embedding.
``train_loss`` takes a ``ctx``: on a mesh with a ``model`` axis of more
than one position each rank runs every attention (the encoder's, the
decoder's self- and cross-attention) over its heads and every MLP over
its ``d_ff`` on its data shard, the frame projection whole.
``init_cache``, ``prefill`` and ``decode_step`` take the same ``ctx``:
the rank's data shard served over its heads and ``d_ff``, the self and
cross caches over its kv heads.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.collectives import model_axis
from repro_torch.models import layers as L
from repro_torch.models import transformer
from repro_torch.sharding.partition import (batch_rows, check_tensor_parallel,
                                            vocab_ctx)

PyTree = Any

SLACK = 64      # empty cache slots after the prompt, as in the reference
CHUNK = 512     # the reference's attention chunk for this family


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return L.torch_dtype(cfg.dtype)


def init_enc_layer(gen: torch.Generator, cfg: ModelConfig, device=None,
                   layers: tuple = ()) -> PyTree:
    """Encoder layers; ``layers`` is a leading stack shape."""
    dt = _dtype(cfg)
    dev = device if device is not None else gen.device
    Ls = tuple(layers)
    return {
        "attn_norm": torch.ones(Ls + (cfg.d_model,), dtype=dt, device=dev),
        "attn": L.init_attention(gen, cfg, dt, dev, Ls),
        "mlp_norm": torch.ones(Ls + (cfg.d_model,), dtype=dt, device=dev),
        "mlp": L.init_mlp(gen, cfg.d_model, cfg.d_ff, dt, dev, Ls),
    }


def init_dec_layer(gen: torch.Generator, cfg: ModelConfig, device=None,
                   layers: tuple = ()) -> PyTree:
    """Decoder layers; ``layers`` is a leading stack shape."""
    dt = _dtype(cfg)
    dev = device if device is not None else gen.device
    Ls = tuple(layers)
    return {
        "self_norm": torch.ones(Ls + (cfg.d_model,), dtype=dt, device=dev),
        "self_attn": L.init_attention(gen, cfg, dt, dev, Ls),
        "cross_norm": torch.ones(Ls + (cfg.d_model,), dtype=dt, device=dev),
        "cross_attn": L.init_attention(gen, cfg, dt, dev, Ls),
        "mlp_norm": torch.ones(Ls + (cfg.d_model,), dtype=dt, device=dev),
        "mlp": L.init_mlp(gen, cfg.d_model, cfg.d_ff, dt, dev, Ls),
    }


def init_params(gen: torch.Generator, cfg: ModelConfig,
                device: DeviceLike = None) -> PyTree:
    """Random weights from ``gen`` (drawn on its device), placed on
    ``device`` (``cuda`` unless asked otherwise), layers stacked."""
    dev = resolve_device(device)
    dt = _dtype(cfg)
    return {
        **L.init_embed(gen, cfg, dt, dev),
        # the stub front end: a learned projection of the frame features
        "frame_proj": {"proj": L.dense_init(gen, (cfg.d_model, cfg.d_model),
                                            cfg.d_model, dt, dev)},
        "enc_layers": init_enc_layer(gen, cfg, dev, (cfg.enc_layers,)),
        "enc_norm": torch.ones((cfg.d_model,), dtype=dt, device=dev),
        "dec_layers": init_dec_layer(gen, cfg, dev, (cfg.n_layers,)),
        "final_norm": torch.ones((cfg.d_model,), dtype=dt, device=dev),
    }


def _positions(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=device)


def encode(params, frames, cfg: ModelConfig, ctx=None, seq=None):
    """frames: (B, T, D) stub embeddings -> the encoder output (B, T, D);
    on a model axis (``ctx``) each layer's attention and MLP over this
    rank's heads and ``d_ff``, the frame projection computed whole. Where
    ``seq`` (the encoder's ``layers.seq_axis``, training) the carry
    between layers and the output are the rank's piece of T: the
    projection and the positions computed whole and split, each norm on
    the piece."""
    T = frames.shape[1]
    h = torch.einsum("btd,de->bte", frames.to(_dtype(cfg)),
                     params["frame_proj"]["proj"])
    h = h + L.sinusoidal_positions(T, cfg.d_model,
                                   device=h.device).to(h.dtype)
    if seq is not None:
        h = seq.split(h)
    positions = _positions(T, h.device)
    chunk = min(CHUNK, T)
    for lp in L.unstack_layers(params["enc_layers"], cfg.enc_layers):
        h = h + L.attention_block(L.carry_norm(h, lp, "attn_norm", ctx, seq),
                                  lp["attn"], cfg, positions=positions,
                                  causal=False, q_chunk=chunk, kv_chunk=chunk,
                                  ctx=ctx, seq=seq)
        h = h + L.mlp_block(L.carry_norm(h, lp, "mlp_norm", ctx, seq),
                            lp["mlp"], ctx, seq)
    return L.carry_norm(h, params, "enc_norm", ctx, seq)


def _cross(x, lp, enc_out, positions, enc_pos, q_chunk, ctx=None, seq=None):
    """The cross-attention sublayer, K/V projected from ``enc_out`` (whole
    on every rank); returns (x with the sublayer added, K, V). On a model
    axis (``ctx``) over this rank's heads: q from ``copy`` of the normed x
    (where ``seq``, x the rank's piece of S: the pieces gathered), K and V
    from ``enc_out`` as the caller gives it (training: the encoder's
    output through ``copy`` or its pieces gathered, once for every
    layer), the output projection's partials summed (reduce-scattered to
    the piece)."""
    p = lp["cross_attn"]
    xn = L.to_split(L.carry_norm(x, lp, "cross_norm", ctx, seq), ctx, seq)
    q = torch.einsum("bsd,dhk->bshk", xn, p["wq"])
    k = torch.einsum("btd,dhk->bthk", enc_out, p["wk"])
    v = torch.einsum("btd,dhk->bthk", enc_out, p["wv"])
    o = L.flash_attention(q, k, v, positions, enc_pos, causal=False,
                          q_chunk=q_chunk, kv_chunk=min(CHUNK, k.shape[1]))
    return x + L.from_split(L.attn_out(o, p["wo"]), ctx, seq), k, v


def _dec_layer(x, lp, cfg: ModelConfig, positions, enc_out, enc_pos,
               q_chunk=CHUNK, ctx=None, seq=None):
    """One decoder layer, the training path (cross K/V recomputed);
    ``seq`` (``layers.seq_axis``): x is the rank's piece of a
    sequence-parallel carry."""
    x = x + L.attention_block(L.carry_norm(x, lp, "self_norm", ctx, seq),
                              lp["self_attn"], cfg, positions=positions,
                              causal=True, q_chunk=q_chunk, kv_chunk=q_chunk,
                              ctx=ctx, seq=seq)
    x, _, _ = _cross(x, lp, enc_out, positions, enc_pos, q_chunk, ctx, seq)
    return x + L.mlp_block(L.carry_norm(x, lp, "mlp_norm", ctx, seq),
                           lp["mlp"], ctx, seq)


def _embed_with_positions(params, tokens, cfg: ModelConfig, offset=0,
                          ctx=None, seq=None):
    """The decoder's token embedding plus its sinusoidal positions; where
    ``seq`` (training, ``layers.seq_axis``) the rank's piece of S of
    both (``layers.embed_carry``)."""
    h = L.embed_carry(tokens, params, ctx, seq)
    pe = L.sinusoidal_positions(tokens.shape[1], cfg.d_model, offset,
                                device=h.device)
    if seq is not None:
        k = pe.shape[0] // seq.size
        pe = pe.narrow(0, seq.pos * k, k)
    return h + pe.to(h.dtype)


def train_loss(params, batch, cfg: ModelConfig, *, ctx=None
               ) -> torch.Tensor:
    """Mean next-token cross-entropy of ``batch`` (``frames``, ``tokens``,
    ``labels`` and an optional ``mask``), f32; each decoder layer
    recomputed in backward when ``cfg.remat``. With ``ctx`` on a mesh
    whose ``model`` axis has ``tp > 1`` positions, ``params`` are this
    rank's model slices (heads, ``d_ff``, the vocab where it splits) and
    ``batch`` its data shard. The encoder's and the decoder's stacks each
    keep their carry as the rank's piece of their sequence where ``tp``
    divides it (``layers.seq_axis``); the encoder's output is taken to
    the decoder's cross-attention once: its pieces gathered, or, where it
    is replicated, through one ``copy``."""
    if ctx is not None:
        check_tensor_parallel(cfg, ctx.tp_size)
    vctx = vocab_ctx(cfg, ctx)
    axis = model_axis(ctx)
    enc_seq = L.seq_axis(ctx, batch["frames"].shape[1])
    enc_out = encode(params, batch["frames"], cfg, ctx, enc_seq)
    if enc_seq is not None:
        enc_out = enc_seq.gather(enc_out)[0]
    elif axis is not None:
        enc_out = axis.copy(enc_out)
    S = batch["tokens"].shape[1]
    seq = L.seq_axis(ctx, S)
    h = _embed_with_positions(params, batch["tokens"], cfg, ctx=vctx,
                              seq=seq)
    positions = _positions(S, h.device)
    enc_pos = _positions(enc_out.shape[1], h.device)
    for lp in L.unstack_layers(params["dec_layers"], cfg.n_layers):
        h = L.layer_call(lambda x, lp: _dec_layer(
            x, lp, cfg, positions, enc_out, enc_pos, ctx=ctx, seq=seq), h, lp,
            enabled=cfg.remat)
    h = L.carry_norm(h, params, "final_norm", ctx, seq)
    return L.lm_loss_chunked(h, params, batch["labels"], L.loss_mask(batch),
                             cfg, ctx=vctx, seq=seq)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               device: DeviceLike = None, ctx=None) -> PyTree:
    """A zero cache on ``device`` (``cuda`` unless asked otherwise); with
    ``ctx`` on a mesh this rank's slice (``partition.state_slices``): its
    data shard of the ``batch`` rows and its kv heads of the self and
    cross caches."""
    dev = resolve_device(device)
    dt = _dtype(cfg)
    lo, hi = batch_rows(batch, ctx)
    Hk, Dh, Ln, T = (transformer._kv_heads(cfg, ctx), cfg.head_dim,
                     cfg.n_layers, cfg.enc_seq)
    B = hi - lo
    return {
        "k": torch.zeros((Ln, B, cache_len, Hk, Dh), dtype=dt, device=dev),
        "v": torch.zeros((Ln, B, cache_len, Hk, Dh), dtype=dt, device=dev),
        "cross_k": torch.zeros((Ln, B, T, Hk, Dh), dtype=dt, device=dev),
        "cross_v": torch.zeros((Ln, B, T, Hk, Dh), dtype=dt, device=dev),
        "kpos": torch.full((cache_len,), -1, dtype=torch.int32, device=dev),
        "pos": torch.zeros((), dtype=torch.int32, device=dev),
    }


def prefill(params, batch, cfg: ModelConfig, spec=None, ctx=None):
    """Encode ``batch["frames"]``, then the teacher-forced decoder pass over
    ``batch["tokens"]``, building the self- and cross-attention caches.
    Returns (logits of the last position (B, 1, V) f32, cache). With
    ``ctx`` on a mesh whose ``model`` axis has more than one position,
    ``params`` are this rank's model slices and ``batch`` its data shard:
    every attention runs over its heads (the decoder's self-attention
    through the sw_attention kernel on the card), every MLP over its
    ``d_ff``, the cross K/V come from ``copy`` of the encoder output and
    both caches hold its kv heads; the embedding and the head are whole
    where the vocab does not split."""
    if ctx is not None:
        check_tensor_parallel(cfg, ctx.tp_size)
    vctx = vocab_ctx(cfg, ctx)
    enc_out = encode(params, batch["frames"], cfg, ctx)
    tokens = batch["tokens"]
    B, S = tokens.shape
    T = enc_out.shape[1]
    dt = _dtype(cfg)
    x = _embed_with_positions(params, tokens, cfg, ctx=vctx)
    positions = _positions(S, x.device)
    enc_pos = _positions(T, x.device)
    shape = (cfg.n_layers, B, S + SLACK, transformer._kv_heads(cfg, ctx),
             cfg.head_dim)
    ks = torch.zeros(shape, dtype=dt, device=x.device)
    vs = torch.zeros(shape, dtype=dt, device=x.device)
    cks, cvs = [], []
    dec = L.unstack_layers(params["dec_layers"], cfg.n_layers)
    for i, lp in enumerate(dec):
        p = lp["self_attn"]
        q, k, v = L.qkv_project(L.rms_norm(x, lp["self_norm"]), p, cfg,
                                positions, ctx)
        o = transformer.prefill_attention(q, k, v, positions, cfg, 0)
        x = x + transformer._attn_out(o, p["wo"], ctx)
        x, ck, cv = _cross(x, lp, enc_out, positions, enc_pos, min(CHUNK, S),
                           ctx)
        x = x + L.mlp_block(L.rms_norm(x, lp["mlp_norm"]), lp["mlp"], ctx)
        # slots past S stay empty: room for the tokens decoded next
        ks[i, :, :S] = k.to(dt)
        vs[i, :, :S] = v.to(dt)
        cks.append(ck.to(dt))
        cvs.append(cv.to(dt))
    h = L.rms_norm(x, params["final_norm"])
    logits = L.lm_logits(h[:, -1:], params, vctx)
    kpos = torch.full((S + SLACK,), -1, dtype=torch.int32, device=x.device)
    kpos[:S] = positions
    cache = {"k": ks, "v": vs, "cross_k": torch.stack(cks),
             "cross_v": torch.stack(cvs), "kpos": kpos,
             "pos": torch.tensor(S, dtype=torch.int32, device=x.device)}
    return logits, cache


def decode_step(params, cache, tokens, cfg: ModelConfig, spec=None,
                ctx=None):
    """One decode step. tokens: (B, 1) -> (logits (B, 1, V) f32, the
    cache), its K/V and ``kpos`` written in place at slot ``pos``. Raises
    ``ValueError`` when the cache has no slot left. With ``ctx``, as
    :func:`prefill`."""
    pos = int(cache["pos"])
    cache_len = cache["k"].shape[2]
    if pos >= cache_len:
        raise ValueError(f"decode at position {pos}: the cache holds "
                         f"{cache_len} slots")
    vctx = vocab_ctx(cfg, ctx)
    axis = model_axis(ctx)
    x = _embed_with_positions(params, tokens, cfg, offset=cache["pos"],
                              ctx=vctx)
    positions = torch.tensor([pos], dtype=torch.int32, device=x.device)
    kpos = cache["kpos"]
    kpos[pos] = pos
    T = cache["cross_k"].shape[2]
    enc_pos = _positions(T, x.device)
    kv_chunk = min(1024, cache_len)
    dec = L.unstack_layers(params["dec_layers"], cfg.n_layers)
    for i, lp in enumerate(dec):
        kc, vc = cache["k"][i], cache["v"][i]
        p = lp["self_attn"]
        q, k, v = L.qkv_project(L.rms_norm(x, lp["self_norm"]), p, cfg,
                                positions, ctx)
        kc[:, pos] = k[:, 0].to(kc.dtype)
        vc[:, pos] = v[:, 0].to(vc.dtype)
        o = L.flash_attention(q, kc, vc, positions, kpos, causal=True,
                              q_chunk=1, kv_chunk=kv_chunk)
        x = x + transformer._attn_out(o, p["wo"], ctx)
        pc = lp["cross_attn"]
        xn = L.rms_norm(x, lp["cross_norm"])
        if axis is not None:
            xn = axis.copy(xn)
        qc = torch.einsum("bsd,dhk->bshk", xn, pc["wq"])
        oc = L.flash_attention(qc, cache["cross_k"][i], cache["cross_v"][i],
                               positions, enc_pos, causal=False, q_chunk=1,
                               kv_chunk=min(CHUNK, T))
        x = x + transformer._attn_out(oc, pc["wo"], ctx)
        x = x + L.mlp_block(L.rms_norm(x, lp["mlp_norm"]), lp["mlp"], ctx)
    h = L.rms_norm(x, params["final_norm"])
    logits = L.lm_logits(h, params, vctx)
    cache["pos"] = cache["pos"] + 1
    return logits, cache
