"""Unified model API across the served families.

``get_model(cfg)`` returns a ``ModelOps`` bundle:

- ``init_params(gen, cfg, device=None)``                      -> params tree
- ``init_cache(cfg, batch, seq_len, device=None, ctx=None)``  -> serving state
- ``prefill(params, batch, cfg, ctx=None)``                   -> (logits, state)
- ``decode_step(params, state, tokens, cfg, ctx=None)``       -> (logits, state)
- ``train_loss(params, batch, cfg, ctx=None)``                 -> mean loss (f32)
- ``stacked_layers``: the ``(key, layer count)`` of each stacked subtree of
  the params, which the trainer's per-layer leaves split
  (``layers.split_layers``)
- ``remat_layers``: the ``(key, parts)`` of each stacked subtree whose
  layers ``train_loss`` runs one by one through ``layers.layer_call``
  (the mesh step gathers each such layer's slices while it runs)
- ``tensor_parallel``: whether ``train_loss`` splits its forward over a
  mesh's ``model`` axis (every family: ``params`` then holds this rank's
  model slices and ``batch`` its data shard; the Mamba2 mixer's SSD
  heads, the attention's heads, the MLPs' ``d_ff``, the experts and the
  vocab where it splits)

The serving calls take the same ``ctx``: on a mesh each rank serves its
data shard of the batch over its model slices (``params``), its state is
its slice of the whole (``sharding.partition.state_slices``: the data
shard's rows, its kv heads, SSD heads and conv channels) and the logits
are the whole vocab's on every rank; ``init_cache`` takes the global
batch.

The port serves and trains every family: ``dense``, ``moe`` (every layer
MoE, or dense and MoE layers interleaved), ``vlm`` (a patch prefix),
``ssm``, ``hybrid`` and ``audio`` (encoder-decoder). The dense, MoE and
VLM families take the perf variants, ``kv_quant`` (an int8 cache with f32
scales, which ``init_cache``, ``prefill`` and ``decode_step`` pass on as
it is) and ``triangle_prefill`` (accepted; every causal prefill already
visits only the tiles at or below the diagonal); the ssm, hybrid and
audio families ignore both, as the reference does. The cache geometry
(ring vs linear) is decided by ``serve_cache_len``, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec, hybrid, ssm, transformer

@dataclasses.dataclass(frozen=True)
class ModelOps:
    init_params: Callable
    train_loss: Callable
    init_cache: Callable          # (cfg, batch, seq_len, device, ctx) -> state
    prefill: Callable             # (params, batch, cfg, ctx) -> (logits, state)
    decode_step: Callable         # (params, state, tokens, cfg, ctx) -> (logits, state)
    supports_long_context: bool   # sub-quadratic serve path exists
    # (params key, layer count) of each subtree stacked over its layers:
    # ``layers`` (dense, MoE, VLM, ssm and the hybrid's Mamba2 backbone;
    # an interleaved model's stacks its ``n_layers // 2`` dense + MoE
    # pairs; the hybrid's ``shared`` block is one unstacked layer),
    # ``enc_layers`` and ``dec_layers`` (the encoder-decoder)
    stacked_layers: tuple = ()
    tensor_parallel: bool = True
    # (params key, parts) of each stacked subtree whose layers
    # ``train_loss`` runs through ``layers.layer_call`` (recomputed in
    # backward when ``cfg.remat``), in the order it runs them: each layer,
    # or each of its ``parts`` (an interleaved model's dense and MoE
    # layer), is a group of the mesh step's slice plan
    # (``sharding.partition.SlicePlan``)
    remat_layers: tuple = ()


def serve_cache_len(cfg: ModelConfig, seq_len: int) -> int:
    """Slots in the dense KV cache for a decode at context ``seq_len``."""
    if cfg.sliding_window and seq_len > cfg.sliding_window:
        return cfg.sliding_window
    return seq_len


def _transformer_ops(cfg: ModelConfig) -> ModelOps:
    def init_cache(cfg, batch, seq_len, device=None, ctx=None):
        spec = transformer.cache_spec(cfg, seq_len, use_window=True)
        return transformer.init_cache(None, cfg, batch, spec, device, ctx)

    def prefill(params, batch, cfg, ctx=None, *, slack: int = 64):
        S = batch["tokens"].shape[1]
        if cfg.family == "vlm" and "patches" in batch:
            S += cfg.n_patches          # the image prefix takes cache slots
        # slack: empty slots for tokens generated after the prefill
        spec = transformer.cache_spec(cfg, S + slack, use_window=False)
        return transformer.prefill(params, batch, cfg, spec, ctx)

    def decode_step(params, cache, tokens, cfg, ctx=None):
        # the geometry is fixed: a ring when the cache is the window long
        cache_len = cache["k"].shape[2]
        spec = transformer.CacheSpec(
            cache_len=cache_len,
            ring=bool(cfg.sliding_window) and cache_len == cfg.sliding_window)
        return transformer.decode_step(params, cache, tokens, cfg, spec,
                                       ctx)

    return ModelOps(
        init_params=transformer.init_params,
        train_loss=transformer.train_loss,
        init_cache=init_cache,
        prefill=prefill,
        decode_step=decode_step,
        supports_long_context=bool(cfg.sliding_window),
        stacked_layers=(("layers", cfg.n_layers // 2
                         if transformer.interleaved(cfg) else cfg.n_layers),),
        remat_layers=(("layers", ("dense", "moe")
                       if transformer.interleaved(cfg) else ()),),
    )


def _ssm_ops(cfg: ModelConfig) -> ModelOps:
    return ModelOps(
        init_params=ssm.init_params,
        train_loss=ssm.train_loss,
        init_cache=lambda cfg, batch, seq_len, device=None, ctx=None:
        ssm.init_state(cfg, batch, device, ctx),
        prefill=lambda params, batch, cfg, ctx=None: ssm.prefill(
            params, batch, cfg, ctx=ctx),
        decode_step=lambda params, state, tokens, cfg, ctx=None:
        ssm.decode_step(params, state, tokens, cfg, ctx=ctx),
        supports_long_context=True,
        stacked_layers=(("layers", cfg.n_layers),),
        remat_layers=(("layers", ()),),
    )


def _hybrid_ops(cfg: ModelConfig) -> ModelOps:
    return ModelOps(
        init_params=hybrid.init_params,
        train_loss=hybrid.train_loss,
        init_cache=lambda cfg, batch, seq_len, device=None, ctx=None:
        hybrid.init_state(cfg, batch, seq_len, device, ctx),
        prefill=lambda params, batch, cfg, ctx=None: hybrid.prefill(
            params, batch, cfg, ctx=ctx),
        decode_step=lambda params, state, tokens, cfg, ctx=None:
        hybrid.decode_step(params, state, tokens, cfg, ctx=ctx),
        supports_long_context=True,
        stacked_layers=(("layers", cfg.n_layers),),
        remat_layers=(("layers", ()),),
    )


def _encdec_ops(cfg: ModelConfig) -> ModelOps:
    return ModelOps(
        init_params=encdec.init_params,
        train_loss=encdec.train_loss,
        init_cache=lambda cfg, batch, seq_len, device=None, ctx=None:
        encdec.init_cache(cfg, batch, seq_len, device, ctx),
        prefill=lambda params, batch, cfg, ctx=None: encdec.prefill(
            params, batch, cfg, ctx=ctx),
        decode_step=lambda params, state, tokens, cfg, ctx=None:
        encdec.decode_step(params, state, tokens, cfg, ctx=ctx),
        supports_long_context=False,   # the 30 s encoder-decoder format
        stacked_layers=(("enc_layers", cfg.enc_layers),
                        ("dec_layers", cfg.n_layers)),
        # the encoder runs without remat (as the reference's): whole
        remat_layers=(("dec_layers", ()),),
    )


def get_model(cfg: ModelConfig) -> ModelOps:
    if cfg.family in ("dense", "moe", "vlm"):
        return _transformer_ops(cfg)
    if cfg.family == "ssm":
        return _ssm_ops(cfg)
    if cfg.family == "hybrid":
        return _hybrid_ops(cfg)
    if cfg.family == "audio":
        return _encdec_ops(cfg)
    raise ValueError(f"unknown family {cfg.family!r}")
