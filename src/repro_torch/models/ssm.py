"""Mamba2 (SSD, state-space duality) language model [arXiv:2405.21060],
serve path.

The port of ``repro.models.ssm`` for one device. The sequence is processed
in chunks of ``cfg.ssm_chunk`` tokens: within a chunk the recurrence is
computed in its dual quadratic (attention-like) form, and the state is
carried from chunk to chunk by a short recurrence. The SSD scan is
``kernels.ssd_scan.ops.ssd_chunked_kernel``, the drop-in that the JAX
package documents for its pure-jnp ``ssd_chunked``: on the card its
intra-chunk part is the ``ssd_intra`` CUDA kernel, on the CPU the kernel's
plain version.

Simplifications kept from the reference: a single B/C group
(n_groups=1), the depthwise short conv applied to x only.

One layer's prefill is ``mixer_prefill``, which ``prefill`` and the
hybrid family (``models.hybrid``) both run. Decode is the O(1) recurrent
form, h <- a·h + dt·B⊗x per layer, in plain torch: no TPU kernel covers
it.

Training (``train_loss``, ``mixer_fwd``) runs the scan through the plain
``ssd_chunked_plain`` on every device, as the reference trains through its
jnp oracle: autograd differentiates it, and the ssd_intra kernel is
forward-only. Each layer is recomputed in backward when ``cfg.remat``.

Parameters keep the reference's stacked leaves: every per-layer weight has
a leading ``n_layers`` dim under ``params["layers"]``, walked by a Python
loop, so ``interop.from_numpy_tree`` carries the reference's params across
unchanged and the SCAR block partition matches. ``train_loss`` takes a
``ctx``: on a mesh with a ``model`` axis of more than one position each
rank runs the mixer over its SSD heads (``mixer_fwd``) on its data shard;
``init_state``, ``prefill`` and ``decode_step`` take the same ``ctx`` and
serve the rank's data shard over its SSD heads (``mixer_prefill``,
``mixer_decode``), its state holding theirs.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.collectives import model_axis
from repro_torch.kernels.ssd_scan.ops import (ssd_chunked_kernel,
                                              ssd_chunked_plain)
from repro_torch.models import layers as L
from repro_torch.sharding.partition import (batch_rows, check_tensor_parallel,
                                            vocab_ctx)

PyTree = Any


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return L.torch_dtype(cfg.dtype)


def init_mixer(gen: torch.Generator, cfg: ModelConfig, device=None,
               layers: tuple = ()) -> PyTree:
    dt = _dtype(cfg)
    D, DI, N, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    Ls = tuple(layers)
    dev = device if device is not None else gen.device
    return {
        # in_proj -> [z (DI), x (DI), B (N), C (N), dt (H)]
        "in_proj": L.dense_init(gen, Ls + (D, 2 * DI + 2 * N + H), D, dt, dev),
        "conv_w": L.dense_init(gen, Ls + (cfg.conv_width, DI),
                               cfg.conv_width, dt, dev),
        "A_log": torch.zeros(Ls + (H,), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros(Ls + (H,), dtype=torch.float32, device=dev),
        "D_skip": torch.ones(Ls + (H,), dtype=torch.float32, device=dev),
        "out_proj": L.dense_init(gen, Ls + (DI, D), DI, dt, dev),
    }


def init_layer(gen: torch.Generator, cfg: ModelConfig, device=None,
               layers: tuple = ()) -> PyTree:
    """One Mamba2 layer (its pre-norm and mixer); ``layers`` is a leading
    stack shape, e.g. ``(n_layers,)``."""
    dev = device if device is not None else gen.device
    return {"norm": torch.ones(tuple(layers) + (cfg.d_model,),
                               dtype=_dtype(cfg), device=dev),
            "mixer": init_mixer(gen, cfg, dev, layers)}


def init_params(gen: torch.Generator, cfg: ModelConfig,
                device: DeviceLike = None) -> PyTree:
    """Random weights from ``gen`` (drawn on its device), placed on
    ``device`` (``cuda`` unless asked otherwise), layers stacked."""
    dev = resolve_device(device)
    return {
        **L.init_embed(gen, cfg, _dtype(cfg), dev),
        "layers": init_layer(gen, cfg, dev, (cfg.n_layers,)),
        "final_norm": torch.ones((cfg.d_model,), dtype=_dtype(cfg),
                                 device=dev),
    }


# ---------------------------------------------------------------------------
# mixer forward pieces
# ---------------------------------------------------------------------------

def _split_proj(zxbcdt, cfg: ModelConfig, DI=None):
    """z, x, B, C, dt of ``in_proj``'s output; ``DI`` is the z and x
    width (default ``d_inner``; a model position's channels on a mesh)."""
    DI, N = DI or cfg.d_inner, cfg.ssm_state
    z = zxbcdt[..., :DI]
    x = zxbcdt[..., DI:2 * DI]
    Bm = zxbcdt[..., 2 * DI:2 * DI + N]
    Cm = zxbcdt[..., 2 * DI + N:2 * DI + 2 * N]
    dt = zxbcdt[..., 2 * DI + 2 * N:]
    return z, x, Bm, Cm, dt


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) as jax.nn.softplus computes it (logaddexp(x, 0))."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-torch.abs(x)))


def _causal_conv(x, w, state=None):
    """Depthwise causal conv. x: (B,S,DI); w: (K,DI); state: (B,K-1,DI)."""
    K = w.shape[0]
    if state is None:
        xp = F.pad(x, (0, 0, K - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    S = x.shape[1]
    out = xp[:, 0:S] * w[0]
    for i in range(1, K):
        out = out + xp[:, i:i + S] * w[i]
    new_state = xp[:, -(K - 1):] if K > 1 else None
    return F.silu(out), new_state


def ssd_chunked(x, dt, A, Bm, Cm, cfg: ModelConfig, h0=None):
    """Chunked SSD scan, the kernel-backed ``ssd_chunked_kernel``.

    x: (B,S,H,P); dt: (B,S,H) (post-softplus); A: (H,) negative;
    Bm, Cm: (B,S,N). Returns (y (B,S,H,P), h_final (B,H,P,N)).
    """
    return ssd_chunked_kernel(x, dt, A, Bm, Cm, cfg.ssm_chunk, h0)


def mixer_fwd(x, p, cfg: ModelConfig, ctx=None):
    """x: (B,S,D) -> (B,S,D), the training path: the plain, differentiable
    SSD scan. On a model axis (``ctx``) ``p`` holds this rank's SSD heads
    (``sharding.partition.model_slices``: their z, x and dt columns of
    ``in_proj`` and every B and C column, their conv channels, ``A_log``,
    ``dt_bias`` and ``D_skip`` entries and ``out_proj`` rows): x enters
    through ``copy``, the scan runs over those heads, and the output
    projection's partials are summed over the axis."""
    axis = model_axis(ctx)
    H, P = cfg.ssm_heads, cfg.ssm_headdim
    if axis is not None:
        x = axis.copy(x)
        H //= axis.size
    DI = H * P
    zxbcdt = torch.einsum("bsd,de->bse", x, p["in_proj"])
    z, xi, Bm, Cm, dtr = _split_proj(zxbcdt, cfg, DI)
    xi, _ = _causal_conv(xi, p["conv_w"])
    Bsz, S, _ = x.shape
    xh = xi.reshape(Bsz, S, H, P).to(torch.float32)
    dt = _softplus(dtr.to(torch.float32) + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y, _ = ssd_chunked_plain(xh, dt, A, Bm.to(torch.float32),
                             Cm.to(torch.float32), cfg.ssm_chunk)
    y = y + xh * p["D_skip"][:, None]
    y = y.reshape(Bsz, S, DI).to(x.dtype) * F.silu(z)
    out = torch.einsum("bse,ed->bsd", y, p["out_proj"])
    return out if axis is None else axis.reduce(out)


def _heads(cfg: ModelConfig, axis) -> int:
    """The SSD heads a rank runs: all, or on a model ``axis`` its share."""
    return cfg.ssm_heads if axis is None else cfg.ssm_heads // axis.size


def mixer_prefill(x, lp, cfg: ModelConfig, ctx=None):
    """One Mamba2 layer over a prompt, the serve path: x: (B,S,D) and the
    layer's params ``lp`` (``norm``, ``mixer``) -> (x + the mixer's output,
    the final SSM state (B,H,P,N) f32, the conv state (B,K-1,DI)). The SSD
    scan is the kernel-backed :func:`ssd_chunked`. On a model axis
    (``ctx``) ``lp["mixer"]`` holds this rank's SSD heads (as in
    :func:`mixer_fwd`): the scan runs over them, the states are theirs
    (H / tp heads, their DI / tp channels) and the output projection's
    partials are summed over the axis."""
    axis = model_axis(ctx)
    Bsz, S, _ = x.shape
    H, P = _heads(cfg, axis), cfg.ssm_headdim
    xn = L.rms_norm(x, lp["norm"])
    if axis is not None:
        xn = axis.copy(xn)
    p = lp["mixer"]
    zxbcdt = torch.einsum("bsd,de->bse", xn, p["in_proj"])
    z, xi, Bm, Cm, dtr = _split_proj(zxbcdt, cfg, H * P)
    xi, conv_state = _causal_conv(xi, p["conv_w"])
    xh = xi.reshape(Bsz, S, H, P).to(torch.float32)
    dt = _softplus(dtr.to(torch.float32) + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y, h_fin = ssd_chunked(xh, dt, A, Bm.to(torch.float32),
                           Cm.to(torch.float32), cfg)
    y = y + xh * p["D_skip"][:, None]
    y = y.reshape(Bsz, S, H * P).to(x.dtype) * F.silu(z)
    out = torch.einsum("bse,ed->bsd", y, p["out_proj"])
    return x + (out if axis is None else axis.reduce(out)), h_fin, \
        conv_state


def mixer_decode(x, p, state, cfg: ModelConfig, ctx=None):
    """Single-token recurrent step. x: (B,1,D); state: dict(h, conv). On a
    model axis (``ctx``) over this rank's SSD heads and their state, the
    output projection's partials summed over the axis."""
    axis = model_axis(ctx)
    H, P = _heads(cfg, axis), cfg.ssm_headdim
    if axis is not None:
        x = axis.copy(x)
    zxbcdt = torch.einsum("bsd,de->bse", x, p["in_proj"])
    z, xi, Bm, Cm, dtr = _split_proj(zxbcdt, cfg, H * P)
    xi, conv_state = _causal_conv(xi, p["conv_w"], state["conv"])
    Bsz = x.shape[0]
    xh = xi.reshape(Bsz, H, P).to(torch.float32)
    dt = _softplus(dtr[:, 0].to(torch.float32) + p["dt_bias"])    # (B,H)
    A = -torch.exp(p["A_log"])
    a = torch.exp(dt * A)                                        # (B,H)
    h = state["h"] * a[:, :, None, None] \
        + torch.einsum("bh,bn,bhp->bhpn", dt, Bm[:, 0].to(torch.float32), xh)
    y = torch.einsum("bn,bhpn->bhp", Cm[:, 0].to(torch.float32), h)
    y = y + xh * p["D_skip"][:, None]
    y = y.reshape(Bsz, 1, H * P).to(x.dtype) * F.silu(z)
    out = torch.einsum("bse,ed->bsd", y, p["out_proj"])
    return (out if axis is None else axis.reduce(out)), \
        {"h": h, "conv": conv_state}


# ---------------------------------------------------------------------------
# model-level API
# ---------------------------------------------------------------------------

def train_loss(params, batch, cfg: ModelConfig, *, ctx=None
               ) -> torch.Tensor:
    """Mean next-token cross-entropy of ``batch`` (``tokens``, ``labels``
    and an optional ``mask``), f32. With ``ctx`` on a mesh whose ``model``
    axis has ``tp > 1`` positions, ``params`` are this rank's model slices
    and ``batch`` its data shard (raises ``ValueError`` where the SSD
    heads do not split over ``tp``)."""
    if ctx is not None:
        check_tensor_parallel(cfg, ctx.tp_size)
    vctx = vocab_ctx(cfg, ctx)
    h = L.embed_tokens(batch["tokens"], params, vctx)
    for lp in L.unstack_layers(params["layers"], cfg.n_layers):
        h = h + L.layer_call(lambda x, lp: mixer_fwd(
            L.rms_norm(x, lp["norm"]), lp["mixer"], cfg, ctx), h, lp,
            enabled=cfg.remat)
    h = L.rms_norm(h, params["final_norm"])
    return L.lm_loss_chunked(h, params, batch["labels"], L.loss_mask(batch),
                             cfg, ctx=vctx)


def init_state(cfg: ModelConfig, batch: int, device: DeviceLike = None,
               ctx=None) -> PyTree:
    """A zero state on ``device`` (``cuda`` unless asked otherwise); with
    ``ctx`` on a mesh this rank's slice (``partition.state_slices``): its
    data shard of the ``batch`` rows and its SSD heads' ``h`` and conv
    channels."""
    dev = resolve_device(device)
    if ctx is not None:
        check_tensor_parallel(cfg, ctx.tp_size)
    tp = 1 if ctx is None else ctx.tp_size
    lo, hi = batch_rows(batch, ctx)
    H, P, N = cfg.ssm_heads // tp, cfg.ssm_headdim, cfg.ssm_state
    return {
        "h": torch.zeros((cfg.n_layers, hi - lo, H, P, N),
                         dtype=torch.float32, device=dev),
        "conv": torch.zeros((cfg.n_layers, hi - lo, cfg.conv_width - 1,
                             cfg.d_inner // tp), dtype=torch.float32,
                            device=dev),
        "pos": torch.zeros((), dtype=torch.int32, device=dev),
    }


def prefill(params, batch, cfg: ModelConfig, spec=None, ctx=None):
    """Run the chunked scan over the prompt, carrying the final SSM states.
    Returns (logits of the last position (B, 1, V) f32, state). With
    ``ctx`` on a mesh whose ``model`` axis has more than one position,
    ``params`` are this rank's model slices and ``batch`` its data shard:
    every layer runs over its SSD heads (:func:`mixer_prefill`, the
    ssd_intra kernel on the card), the state holds theirs, the logits are
    the whole vocab's."""
    if ctx is not None:
        check_tensor_parallel(cfg, ctx.tp_size)
    vctx = vocab_ctx(cfg, ctx)
    tokens = batch["tokens"]
    x = L.embed_tokens(tokens, params, vctx)
    S = tokens.shape[1]
    hs, convs = [], []
    for i in range(cfg.n_layers):
        x, h_fin, conv_state = mixer_prefill(x, L.layer_params(params, i),
                                             cfg, ctx)
        hs.append(h_fin)
        convs.append(conv_state)
    hfin = L.rms_norm(x, params["final_norm"])
    logits = L.lm_logits(hfin[:, -1:], params, vctx)
    state = {"h": torch.stack(hs), "conv": torch.stack(convs),
             "pos": torch.tensor(S, dtype=torch.int32, device=x.device)}
    return logits, state


def decode_step(params, state, tokens, cfg: ModelConfig, spec=None,
                ctx=None):
    """One recurrent step. tokens: (B, 1) -> (logits (B, 1, V) f32, the
    new state; the given state is left as it was). With ``ctx``, as
    :func:`prefill`: this rank's SSD heads and data shard."""
    vctx = vocab_ctx(cfg, ctx)
    x = L.embed_tokens(tokens, params, vctx)
    hs, convs = [], []
    for i in range(cfg.n_layers):
        lp = L.layer_params(params, i)
        out, new = mixer_decode(L.rms_norm(x, lp["norm"]), lp["mixer"],
                                {"h": state["h"][i], "conv": state["conv"][i]},
                                cfg, ctx)
        x = x + out
        hs.append(new["h"])
        convs.append(new["conv"])
    h = L.rms_norm(x, params["final_norm"])
    logits = L.lm_logits(h, params, vctx)
    return logits, {"h": torch.stack(hs), "conv": torch.stack(convs),
                    "pos": state["pos"] + 1}
