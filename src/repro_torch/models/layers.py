"""Shared transformer layers: RMSNorm, RoPE, sinusoidal positions (the
encoder-decoder family), chunked (flash-style) GQA
attention with its backward, SwiGLU MLP, embedding, the LM head and the
chunked LM loss.

The port of ``repro.models.layers`` for one device: plain functions on
tensors, explicit ``torch.Generator``s for the initialisers. The
attention is the reference's chunked online softmax
(``_fwd_chunks``/``_attend_chunk``), a plain version that never holds more
than one (q_chunk x kv_chunk) tile of scores. Training takes its gradient
through ``_Flash``, the reference's custom VJP as a
``torch.autograd.Function``: the forward keeps ``o`` and the row
log-sum-exp, and the backward recomputes each tile (no S x S matrix is
kept). Decode uses the forward on every device; prefill uses it on the
CPU, and on the card prefill goes through the ``sw_attention`` kernel
(``repro_torch.models.transformer``). ``lm_loss_chunked`` recomputes each
chunk's logits in backward (``torch.utils.checkpoint``).

The MoE block (``init_moe``, ``_moe_body``, ``moe_block``) is the
reference's: token-choice top-k routing, a top-capacity token gather per
expert, the expert products as batched matmuls (on views of the trainer's
2-D expert leaves too, ``split_layers``), a combine in expert order; its
gradient is ``jax.grad``'s of the reference.

**Tensor and expert parallelism.** ``qkv_project``, ``attention_block``,
``mlp_block``, ``moe_block``, ``embed_tokens``, ``lm_logits`` and
``lm_loss_chunked`` take an optional ``ctx`` (a
:class:`~repro_torch.sharding.partition.DistContext`). Without one, or on
a mesh whose ``model`` axis has one position, they run the one-device
code. With a ``model`` axis of ``tp`` positions the weights they are given
are this rank's slices (``sharding.partition.take_model_slices``) and the
activations between layers are replicated over the axis
(``distributed.collectives.ModelAxis``: ``copy`` on the input of a split
computation, whose backward sums the gradient over the axis, and
``reduce`` on its partial output): the attention's heads, the MLP's and
the shared expert's ``d_ff``, the experts (each rank runs ``E / tp`` of
them on the data shard's tokens at the data shard's capacity, the router
replicated in f32, the combine summed, through a reduce-scatter over S
and an all-gather under ``cfg.moe_reduce_scatter``) and the vocab of the
embedding, the LM head and the chunked loss (a logsumexp over the
shards; where the vocab does not split the models call these three
without ``ctx``, ``sharding.partition.vocab_ctx``). The Mamba2 mixer's
SSD heads are split in ``models.ssm.mixer_fwd``. Every replicated computation (norms, the router, its aux
losses) gets its whole gradient on every rank.

The perf variants, forward only and plain on every device (the reference
writes them in jnp; no TPU kernel covers them): ``quantize_kv`` (int8
values and per-(token, head) f32 scales, the reference's arithmetic),
``flash_attention_kvq`` (decode over an int8 cache, each kv chunk
dequantized on its own, the query group kept as ``(Hk, G)``: no repeat of
the cache over G and no float copy of the whole cache) and
``flash_attention_triangle`` (causal prefill attention whose query chunk
``i`` visits only the kv chunks ``j <= i``: the plain route of every
causal prefill, with ``triangle_prefill`` or without).
"""
from __future__ import annotations

import math
from typing import Any, Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.collectives import model_axis
from repro_torch.utils.tree import tree_flatten, tree_map, tree_unflatten

PyTree = Any

NEG_INF = -1e30
# dense_init draws a leaf of more values than this in slices of DRAW_SLICE
DRAW_SLICE_ABOVE = 1 << 31
DRAW_SLICE = 1 << 28


def torch_dtype(name: str) -> torch.dtype:
    """A config's ``dtype`` string as a torch dtype."""
    return getattr(torch, name)


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, shape, in_axis_size: Optional[int] = None,
               dtype=torch.float32, device=None) -> torch.Tensor:
    """Normal(0, 1/fan_in) weights drawn in f32 on the generator's device,
    then cast; ``fan_in`` is ``shape[0]`` unless given."""
    fan_in = in_axis_size if in_axis_size is not None else shape[0]
    scale = 1.0 / math.sqrt(max(fan_in, 1))
    dev = device if device is not None else gen.device
    n = math.prod(shape)
    if n <= DRAW_SLICE_ABOVE:
        w = torch.randn(tuple(shape), generator=gen, device=gen.device,
                        dtype=torch.float32).mul_(scale)
        return w.to(device=dev, dtype=dtype)
    # a leaf past DRAW_SLICE_ABOVE values (the MoE expert stacks at full
    # width: llama4-maverick's are 5.4 G values) is drawn DRAW_SLICE values
    # at a time, so its f32 transient is one slice, not 4 bytes a value
    out = torch.empty(tuple(shape), dtype=dtype, device=dev)
    flat = out.view(-1)
    for lo in range(0, n, DRAW_SLICE):
        hi = min(lo + DRAW_SLICE, n)
        flat[lo:hi] = torch.randn((hi - lo,), generator=gen,
                                  device=gen.device,
                                  dtype=torch.float32).mul_(scale)
    return out


def unstack_layers(layers: PyTree, n: int) -> list:
    """A stacked subtree of layers (``params["layers"]``,
    ``params["enc_layers"]``, ...) as ``n`` per-layer trees, each leaf
    a view from one ``torch.unbind``: autograd gathers the layers'
    gradients back into one stacked gradient per leaf. A list of
    per-layer trees (:func:`split_layers`) is returned as it is."""
    if isinstance(layers, (list, tuple)):
        return list(layers)
    leaves, treedef = tree_flatten(layers)
    per = [torch.unbind(x, 0) for x in leaves]
    return [tree_unflatten(treedef, [p[i] for p in per]) for i in range(n)]


# the expert stacks of an MoE block, held 2-D in the per-layer layout
EXPERT_KEYS = ("w_gate_experts", "w_up_experts", "w_down_experts")


def _own_leaves(node, copy: bool):
    """``node`` with each attention's ``wo`` and each MoE block's expert
    stacks held 2-D, ``(Hq·Dh, D)`` and ``(E·D, F)``/``(E·F, D)``, every
    such leaf a contiguous copy; any other leaf a copy when ``copy``, else
    itself (and a subtree with nothing to change, itself)."""
    if isinstance(node, dict):
        out = {}
        for k, v in node.items():
            if k in ("wo",) + EXPERT_KEYS and isinstance(v, torch.Tensor) \
                    and v.dim() == 3:
                out[k] = v.reshape(-1, v.shape[-1]).clone()
            else:
                out[k] = _own_leaves(v, copy)
        changed = copy or any(out[k] is not v for k, v in node.items())
        return out if changed else node
    if isinstance(node, (list, tuple)):
        out = [_own_leaves(v, copy) for v in node]
        changed = copy or any(a is not b for a, b in zip(out, node))
        return out if changed else node
    return node.clone() if copy else node


def split_layers(params: PyTree, stacked) -> PyTree:
    """``params`` in the trainer's per-layer layout. Each stacked subtree
    is replaced by a list of per-layer trees, each leaf a contiguous copy
    of its layer's slice (the stacked leaves are released); ``stacked`` is
    the ``(key, layer count)`` of each such subtree
    (``ModelOps.stacked_layers``). Throughout the tree (the hybrid's
    ``shared`` block too), an attention's ``wo`` is held as a ``(Hq·Dh,
    D)`` leaf and an MoE block's expert stacks as ``(E·D, F)`` and ``(E·F,
    D)`` leaves; every other leaf outside the stacked subtrees (the
    embedding, the norms) is kept as it is.

    The SCAR partition cuts blocks of ``block_rows`` rows along dim 0 of
    each leaf, and the XOR parity's frames are as wide as the widest
    block: a stacked leaf's blocks span every layer, ``wo``'s ``Hq`` rows
    make it one block of ``Hq·Dh·D`` values and an expert stack's ``E``
    rows one block of ``D·F`` values an expert. Held 2-D, their blocks are
    ``block_rows`` rows of one expert (``D`` and ``F`` are multiples of
    ``block_rows`` at full width). Each reader of these weights
    (``attn_out``, ``_experts``) views either form as it needs it: no
    copy, the same bits."""
    out = dict(params)
    for key, n in stacked:
        out[key] = [_own_leaves(lp, True)
                    for lp in unstack_layers(params[key], n)]
    keys = {key for key, _ in stacked}
    for key, v in params.items():
        if key not in keys:
            out[key] = _own_leaves(v, False)
    return out


def remat(fn, *args, enabled: bool = True):
    """``fn(*args)``, recomputed in backward with nothing saved inside it
    (``torch.utils.checkpoint``, non-reentrant) when ``enabled`` and
    gradients are being recorded: the per-layer remat of the trainer."""
    if enabled and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(
            fn, *args, use_reentrant=False, preserve_rng_state=False)
    return fn(*args)


class GatheredLayer:
    """A layer whose weights a mesh step gathers only while the layer runs
    (``training.step``): ``gather()`` returns a new list of the layer's
    slices (views of a buffer nothing else holds) and ``treedef`` their
    tree; ``send(grads)`` takes their gradient (a list in that order,
    each entry dropped once sent) when the backward has all of it.
    ``anchor`` is a tensor that requires grad, which the step asks the
    gradient of, so the backward reaches every gathered layer."""
    __slots__ = ("gather", "send", "treedef", "anchor")

    def __init__(self, gather, send, treedef, anchor):
        self.gather, self.send = gather, send
        self.treedef, self.anchor = treedef, anchor


class _Gather(torch.autograd.Function):
    """A :class:`GatheredLayer`'s slices as the outputs of one node:
    forward ``layer.gather()``; backward, once the gradient of every
    output is in, ``layer.send`` of it. The node holds no slice, so under
    remat the slices live only while the layer runs."""

    @staticmethod
    def forward(ctx, anchor, layer):
        ctx.layer = layer
        return tuple(layer.gather())

    @staticmethod
    def backward(ctx, *grads):
        ctx.layer.send(list(grads))
        return None, None


def layer_call(fn, x, lp, enabled: bool = True):
    """``fn(x, lp)``, one layer of a model's ``train_loss``, under
    :func:`remat` (recomputed in backward when ``enabled``). ``lp`` is a
    tree of tensors, or a :class:`GatheredLayer` (a mesh step's): then
    ``fn`` gets the tree of its slices gathered as it starts, in the
    forward and again in the recompute, and their gradient goes to
    ``lp.send`` as soon as the backward has it. Every rank runs its
    layers in the same order, so the gathers and sends line up."""
    if isinstance(lp, GatheredLayer):
        return remat(lambda x: fn(x, tree_unflatten(
            lp.treedef, _Gather.apply(lp.anchor, lp))), x, enabled=enabled)
    return remat(lambda x: fn(x, lp), x, enabled=enabled)


def layer_params(params: PyTree, i: int) -> PyTree:
    """Layer ``i`` of ``params["layers"]``: its slice of the stacked
    leaves, or the ``i``-th tree of a per-layer list
    (:func:`split_layers`)."""
    layers = params["layers"]
    if isinstance(layers, (list, tuple)):
        return layers[i]

    def take(node):
        if isinstance(node, dict):
            return {k: take(v) for k, v in node.items()}
        return node[i]
    return take(layers)


# ---------------------------------------------------------------------------
# norms / rope
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * w.to(torch.float32)
    return out.to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., S, H, Dh); positions: broadcastable to (..., S). Half-split
    rotation (the first half of Dh pairs with the second), as the
    reference."""
    if theta <= 0:
        return x
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)                     # (Dh/2,)
    angles = positions[..., None].to(torch.float32) * freqs     # (..., S, Dh/2)
    cos = torch.cos(angles)[..., None, :]                       # (..., S, 1, Dh/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(seq: int, d_model: int, offset=0,
                         device=None) -> torch.Tensor:
    """(seq, d_model) f32 sinusoidal position table of positions
    ``offset .. offset + seq - 1``: sin on the even columns, cos on the odd.
    ``offset`` may be a 0-d tensor (a decode step's position)."""
    if isinstance(offset, torch.Tensor):
        device = offset.device if device is None else device
        offset = offset.to(device=device, dtype=torch.float32)
    pos = (torch.arange(seq, dtype=torch.float32, device=device)
           + offset)[:, None]
    div = torch.exp(torch.arange(0, d_model, 2, dtype=torch.float32,
                                 device=device)
                    * (-math.log(10000.0) / d_model))
    pe = torch.zeros((seq, d_model), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


# ---------------------------------------------------------------------------
# chunked flash-style attention (plain; the CUDA kernel is sw_attention)
# ---------------------------------------------------------------------------

def _attend_chunk(q, k, v, qpos, kpos, *, causal, window, scale,
                  k_scale=None, v_scale=None):
    """One (q_chunk x kv_chunk) tile. q: (B,qc,Hk,G,Dh); k/v: (B,kc,Hk,Dh).
    Optional per-(token, head) dequant scales ``(B, kc, Hk)`` for an int8
    cache, applied to the chunk's f32 k/v. Returns the unnormalised (acc,
    m, l) online-softmax contributions."""
    kf = k.to(torch.float32)
    vf = v.to(torch.float32)
    if k_scale is not None:
        kf = kf * k_scale.to(torch.float32)[..., None]
    if v_scale is not None:
        vf = vf * v_scale.to(torch.float32)[..., None]
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.to(torch.float32), kf) * scale
    if causal:
        mask = kpos[None, :] <= qpos[:, None]
    else:
        mask = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                          device=q.device)
    if window:
        mask = mask & (qpos[:, None] - kpos[None, :] < window)
    mask = mask & (kpos >= 0)[None, :]            # ring-buffer validity
    s = torch.where(mask, s, torch.full((), NEG_INF, device=s.device))
    m = torch.amax(s, dim=-1)                                 # (B,Hk,G,qc)
    p = torch.exp(s - m[..., None])
    p = torch.where(mask, p, torch.zeros((), device=p.device))
    l = torch.sum(p, dim=-1)
    acc = torch.einsum("bhgqk,bkhd->bqhgd", p, vf)
    return acc, m, l


def _softmax_state(B, qc, Hk, G, Dh, device):
    """The empty online-softmax state (acc, m, l) of a query chunk."""
    return (torch.zeros((B, qc, Hk, G, Dh), dtype=torch.float32,
                        device=device),
            torch.full((B, Hk, G, qc), NEG_INF, dtype=torch.float32,
                       device=device),
            torch.zeros((B, Hk, G, qc), dtype=torch.float32, device=device))


def _merge(acc, m, l, a, mt, lt):
    """The state (acc, m, l) after one more tile's (a, mt, lt)."""
    m_new = torch.maximum(m, mt)
    r_old = torch.exp(m - m_new)
    r_new = torch.exp(mt - m_new)
    acc = acc * r_old.permute(0, 3, 1, 2)[..., None] \
        + a * r_new.permute(0, 3, 1, 2)[..., None]
    return acc, m_new, l * r_old + lt * r_new


def _normalise(acc, l):
    """acc / l (l clamped at 1e-30, as the reference), f32."""
    l = torch.clamp_min(l, 1e-30)
    return acc / l.permute(0, 3, 1, 2)[..., None]


def _fwd_chunks(qg, kc, vc, qposc, kposc, *, causal, window, scale,
                q_chunk, kv_chunk, nk, Skv, triangle=False):
    """Forward over all (q-chunk x kv-chunk) tiles with online softmax.

    qg: (B, nq, qc, Hk, G, Dh); kc/vc: (B, nk, kc, Hk, Dh). ``triangle``
    (a causal prefill: q and kv chunks of one size over the same
    positions) visits only the kv chunks ``j <= i``; a tile above the
    diagonal is all masked and adds nothing to the state, so the result
    is the same bits.
    Returns (o (B, nq, qc, Hk, G, Dh) in q's dtype, lse (B, nq, Hk, G, qc)
    f32).
    """
    B, nq = qg.shape[0], qg.shape[1]
    outs, lses = [], []
    for i in range(nq):
        qck, qpck = qg[:, i], qposc[i]
        if triangle:
            chunks = range(i + 1)
        elif window > 0 and Skv > window + q_chunk:
            # sliding window: only a fixed-size kv span can be visible
            span = window + q_chunk
            nspan = min(-(-span // kv_chunk) + 1, nk)
            lo = (int(qpck.min()) - window) // kv_chunk
            lo = min(max(lo, 0), max(nk - nspan, 0))
            chunks = range(lo, lo + nspan)
        else:
            chunks = range(nk)
        acc, m, l = _softmax_state(B, *qck.shape[1:], qg.device)
        for j in chunks:
            acc, m, l = _merge(acc, m, l, *_attend_chunk(
                qck, kc[:, j], vc[:, j], qpck, kposc[j], causal=causal,
                window=window, scale=scale))
        # the output in the input dtype: the backward's D is recomputed in
        # f32 from it, as in the reference
        outs.append(_normalise(acc, l).to(qck.dtype))
        lses.append(m + torch.log(torch.clamp_min(l, 1e-30)))
    return torch.stack(outs, dim=1), torch.stack(lses, dim=1)


def _pad_chunks(q, k, v, qpos, kpos, q_chunk, kv_chunk):
    B, Sq, Hk, G, Dh = q.shape
    Skv = k.shape[1]
    nq = -(-Sq // q_chunk)
    nk = -(-Skv // kv_chunk)
    qpad, kpad = nq * q_chunk - Sq, nk * kv_chunk - Skv
    if qpad:
        q = F.pad(q, (0, 0, 0, 0, 0, 0, 0, qpad))
        qpos = torch.cat([qpos, qpos[-1:].expand(qpad)])
    if kpad:
        k = F.pad(k, (0, 0, 0, 0, 0, kpad))
        v = F.pad(v, (0, 0, 0, 0, 0, kpad))
        kpos = torch.cat([kpos, kpos.new_full((kpad,), -1)])
    qg = q.reshape(B, nq, q_chunk, Hk, G, Dh)
    kc = k.reshape(B, nk, kv_chunk, Hk, Dh)
    vc = v.reshape(B, nk, kv_chunk, Hk, Dh)
    return (qg, kc, vc, qpos.reshape(nq, q_chunk),
            kpos.reshape(nk, kv_chunk), nq, nk)


def _flash_fwd(q, k, v, qpos, kpos, causal, window, q_chunk, kv_chunk,
               triangle=False):
    """q: (B, Sq, Hk, G, Dh); k/v: (B, Skv, Hk, Dh). Returns (o in q's
    shape and dtype, lse (B, nq, Hk, G, qc) f32)."""
    B, Sq, Hk, G, Dh = q.shape
    Skv = k.shape[1]
    scale = 1.0 / math.sqrt(Dh)
    qg, kc, vc, qposc, kposc, nq, nk = _pad_chunks(
        q, k, v, qpos, kpos, q_chunk, kv_chunk)
    o, lse = _fwd_chunks(qg, kc, vc, qposc, kposc, causal=causal,
                         window=window, scale=scale, q_chunk=q_chunk,
                         kv_chunk=kv_chunk, nk=nk, Skv=Skv,
                         triangle=triangle)
    return o.reshape(B, nq * q_chunk, Hk, G, Dh)[:, :Sq], lse


def _tile_mask(qpos, kpos, causal, window):
    if causal:
        mask = kpos[None, :] <= qpos[:, None]
    else:
        mask = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                          device=qpos.device)
    if window:
        mask = mask & (qpos[:, None] - kpos[None, :] < window)
    return mask & (kpos >= 0)[None, :]


def _flash_bwd(q, k, v, qpos, kpos, o, lse, do, causal, window, q_chunk,
               kv_chunk):
    """The reference's ``_flash_core_bwd``: per q chunk, every kv chunk's
    tile is recomputed from the saved ``lse``; dq accumulates over the kv
    chunks and dk/dv over the q chunks, in f32."""
    B, Sq, Hk, G, Dh = q.shape
    Skv = k.shape[1]
    scale = 1.0 / math.sqrt(Dh)
    qg, kc, vc, qposc, kposc, nq, nk = _pad_chunks(
        q, k, v, qpos, kpos, q_chunk, kv_chunk)
    dpad = nq * q_chunk - Sq
    dog = F.pad(do.to(torch.float32), (0, 0, 0, 0, 0, 0, 0, dpad)
                ).reshape(B, nq, q_chunk, Hk, G, Dh)
    og = F.pad(o.to(torch.float32), (0, 0, 0, 0, 0, 0, 0, dpad)
               ).reshape(B, nq, q_chunk, Hk, G, Dh)
    # D_i = rowsum(do * o): (B, nq, Hk, G, qc)
    Drow = torch.einsum("bnqhgd,bnqhgd->bnhgq", dog, og)
    dq_parts = []
    dk = torch.zeros((B, nk, kv_chunk, Hk, Dh), dtype=torch.float32,
                     device=q.device)
    dv = torch.zeros_like(dk)
    for i in range(nq):
        qck = qg[:, i].to(torch.float32)                # (B,qc,Hk,G,Dh)
        dock, lsek, Dk = dog[:, i], lse[:, i], Drow[:, i]
        dq = torch.zeros_like(qck)
        for j in range(nk):
            kt = kc[:, j].to(torch.float32)             # (B,kc,Hk,Dh)
            vt = vc[:, j].to(torch.float32)
            s = torch.einsum("bqhgd,bkhd->bhgqk", qck, kt) * scale
            mask = _tile_mask(qposc[i], kposc[j], causal, window)
            p = torch.where(mask, torch.exp(s - lsek[..., None]),
                            torch.zeros((), device=s.device))
            dv[:, j] += torch.einsum("bhgqk,bqhgd->bkhd", p, dock)
            dp = torch.einsum("bqhgd,bkhd->bhgqk", dock, vt)
            ds = p * (dp - Dk[..., None]) * scale
            dq = dq + torch.einsum("bhgqk,bkhd->bqhgd", ds, kt)
            dk[:, j] += torch.einsum("bhgqk,bqhgd->bkhd", ds, qck)
        dq_parts.append(dq)
    dq = torch.stack(dq_parts, dim=1).reshape(B, nq * q_chunk, Hk, G, Dh)
    dk = dk.reshape(B, nk * kv_chunk, Hk, Dh)[:, :Skv]
    dv = dv.reshape(B, nk * kv_chunk, Hk, Dh)[:, :Skv]
    return (dq[:, :Sq].to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))


class _Flash(torch.autograd.Function):
    """Chunked attention with the reference's flash-style VJP: the forward
    saves q, k, v, o and the row log-sum-exp; the backward recomputes the
    tiles."""

    @staticmethod
    def forward(ctx, q, k, v, qpos, kpos, causal, window, q_chunk,
                kv_chunk):
        o, lse = _flash_fwd(q, k, v, qpos, kpos, causal, window, q_chunk,
                            kv_chunk)
        ctx.save_for_backward(q, k, v, qpos, kpos, o, lse)
        ctx.args = (causal, window, q_chunk, kv_chunk)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, qpos, kpos, o, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q, k, v, qpos, kpos, o, lse, do, *ctx.args)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention(q, k, v, qpos, kpos, *, causal=True, window=0,
                    q_chunk=1024, kv_chunk=1024) -> torch.Tensor:
    """Chunked attention with online softmax and a flash-style backward.

    q: (B, Sq, Hq, Dh);  k, v: (B, Skv, Hk, Dh);  Hq = G·Hk (GQA: query
    head h reads kv head h // G; the kv heads are repeated to Hq, and
    autograd sums their gradients back). qpos: (Sq,) absolute positions;
    kpos: (Skv,) positions (-1 = an empty ring slot). ``window > 0``
    restricts to a sliding window (the forward visits only the kv chunks
    that the band reaches). With gradients needed it runs through
    ``_Flash``; otherwise the forward alone. Returns (B, Sq, Hq, Dh) in
    q's dtype: empty, and nothing computed, where ``Hq`` is 0 (a rank
    of a model axis that holds no query heads).
    """
    B, Sq, Hq, Dh = q.shape
    _, Skv, Hk, _ = k.shape
    if not Hq:
        return q.clone()
    G = Hq // Hk
    q_chunk = min(q_chunk, Sq)
    kv_chunk = min(kv_chunk, Skv)
    if G > 1:
        k = torch.repeat_interleave(k, G, dim=2)
        v = torch.repeat_interleave(v, G, dim=2)
    qg = q.reshape(B, Sq, Hq, 1, Dh)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        o = _Flash.apply(qg, k, v, qpos, kpos, causal, window, q_chunk,
                         kv_chunk)
    else:
        o, _ = _flash_fwd(qg, k, v, qpos, kpos, causal, window, q_chunk,
                          kv_chunk)
    return o.reshape(B, Sq, Hq, Dh).to(q.dtype)


def flash_attention_triangle(q, k, v, qpos, kpos, *, q_chunk=1024,
                             kv_chunk=1024) -> torch.Tensor:
    """Forward-only causal prefill attention with the triangle skip
    (``_fwd_chunks(triangle=True)``): ``flash_attention(causal=True,
    window=0)``'s contract for a prompt over its own positions, the
    plain causal prefill route. The query heads are grouped as ``(Hk,
    G)`` (no repeat of k and v over G). q: (B, Sq, Hq, Dh); k, v: (B, Sq,
    Hk, Dh). Returns (B, Sq, Hq, Dh) in q's dtype (empty where ``Hq`` is
    0)."""
    B, Sq, Hq, Dh = q.shape
    Hk = k.shape[2]
    if not Hq:
        return q.clone()
    chunk = min(q_chunk, kv_chunk, Sq)
    o, _ = _flash_fwd(q.reshape(B, Sq, Hk, Hq // Hk, Dh), k, v, qpos, kpos,
                      True, 0, chunk, chunk, triangle=True)
    return o.reshape(B, Sq, Hq, Dh).to(q.dtype)


# ---------------------------------------------------------------------------
# the int8 KV cache
# ---------------------------------------------------------------------------

def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., Hk, Dh) -> (int8 values, f32 scales (..., Hk)): the
    reference's arithmetic, step for step. The f32 amax over Dh, ``scale =
    max(amax, 1e-8) / 127`` and ``x / scale`` as f32 divisions (each by a
    tensor: a CUDA division by a Python number multiplies by its
    reciprocal, which can move the last bit), round half to even, clip to
    +-127. A zero row gives int8 0 and the scale ``1e-8 / 127``."""
    xf = x.to(torch.float32)
    amax = torch.amax(xf.abs(), dim=-1)
    scale = torch.clamp_min(amax, 1e-8) / torch.full(
        (), 127.0, dtype=torch.float32, device=x.device)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def flash_attention_kvq(q, k8, v8, k_scale, v_scale, qpos, kpos, *,
                        window=0, kv_chunk=1024) -> torch.Tensor:
    """Decode attention over an int8 KV cache: the reference's chunked
    online softmax, one kv chunk at a time, each chunk's k/v dequantized
    in f32 on its own (``_attend_chunk``'s scales). The query heads are
    grouped as ``(Hk, G)``, so the cache is never repeated over G and the
    f32 peak is one chunk's k and v, ``(B, kv_chunk, Hk, Dh)`` each.

    q: (B, Sq, Hq, Dh) (Sq small: decode); k8/v8: (B, Skv, Hk, Dh) int8;
    k_scale/v_scale: (B, Skv, Hk) f32; qpos: (Sq,); kpos: (Skv,) (-1 = an
    empty slot). Causal, banded when ``window > 0``. Returns (B, Sq, Hq,
    Dh) in q's dtype (empty where ``Hq`` is 0)."""
    B, Sq, Hq, Dh = q.shape
    Skv, Hk = k8.shape[1], k8.shape[2]
    if not Hq:
        return q.clone()
    qg = q.reshape(B, Sq, Hk, Hq // Hk, Dh)
    scale = 1.0 / math.sqrt(Dh)
    kv_chunk = min(kv_chunk, Skv)
    acc, m, l = _softmax_state(B, *qg.shape[1:], q.device)
    # a short last chunk is the reference's zero-padded one: its padding is
    # masked (kpos -1) and adds nothing
    for lo in range(0, Skv, kv_chunk):
        hi = min(lo + kv_chunk, Skv)
        acc, m, l = _merge(acc, m, l, *_attend_chunk(
            qg, k8[:, lo:hi], v8[:, lo:hi], qpos, kpos[lo:hi], causal=True,
            window=window, scale=scale, k_scale=k_scale[:, lo:hi],
            v_scale=v_scale[:, lo:hi]))
    return _normalise(acc, l).reshape(B, Sq, Hq, Dh).to(q.dtype)


# ---------------------------------------------------------------------------
# GQA attention block
# ---------------------------------------------------------------------------

def init_attention(gen: torch.Generator, cfg: ModelConfig, dtype,
                   device=None, layers: tuple = ()) -> PyTree:
    """Attention weights; ``layers`` is a leading stack shape, e.g.
    ``(n_layers,)``."""
    D, Hq, Hk, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    L = tuple(layers)
    p = {
        "wq": dense_init(gen, L + (D, Hq, Dh), D, dtype, device),
        "wk": dense_init(gen, L + (D, Hk, Dh), D, dtype, device),
        "wv": dense_init(gen, L + (D, Hk, Dh), D, dtype, device),
        "wo": dense_init(gen, L + (Hq, Dh, D), Hq * Dh, dtype, device),
    }
    if cfg.qkv_bias:
        dev = device if device is not None else gen.device
        p["bq"] = torch.zeros(L + (Hq, Dh), dtype=dtype, device=dev)
        p["bk"] = torch.zeros(L + (Hk, Dh), dtype=dtype, device=dev)
        p["bv"] = torch.zeros(L + (Hk, Dh), dtype=dtype, device=dev)
    return p


def qkv_project(x, p, cfg: ModelConfig, positions, ctx=None):
    """q, k, v of x: (B, S, D) with rope; on a model axis, this rank's
    heads (its slices of ``wq``, ``wk``, ``wv`` and the biases)."""
    axis = model_axis(ctx)
    if axis is not None:
        x = axis.copy(x)
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention_block(x, p, cfg: ModelConfig, *, positions, causal=True,
                    window=0, q_chunk=1024, kv_chunk=1024, ctx=None):
    """Self-attention over x: (B,S,D) -> (B,S,D), the plain attention; on
    a model axis over this rank's heads, the output projections' partials
    summed over the axis."""
    q, k, v = qkv_project(x, p, cfg, positions, ctx)
    o = flash_attention(q, k, v, positions, positions, causal=causal,
                        window=window, q_chunk=q_chunk, kv_chunk=kv_chunk)
    out = attn_out(o, p["wo"])
    axis = model_axis(ctx)
    return out if axis is None else axis.reduce(out)


def attn_out(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """The attention output (B, S, Hq, Dh) through ``wo``, held ``(Hq, Dh,
    D)`` (the stacked layout) or ``(Hq·Dh, D)`` (the per-layer one,
    :func:`split_layers`): one matmul over the flattened heads either
    way, so both layouts give the same bits."""
    return o.flatten(-2) @ wo.reshape(-1, wo.shape[-1])


# ---------------------------------------------------------------------------
# MLP (SwiGLU)
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, dtype,
             device=None, layers: tuple = ()) -> PyTree:
    L = tuple(layers)
    return {
        "w_gate": dense_init(gen, L + (d_model, d_ff), d_model, dtype, device),
        "w_up": dense_init(gen, L + (d_model, d_ff), d_model, dtype, device),
        "w_down": dense_init(gen, L + (d_ff, d_model), d_ff, dtype, device),
    }


def mlp_block(x, p, ctx=None):
    """SwiGLU; on a model axis over this rank's columns of ``d_ff``, the
    down projections' partials summed over the axis."""
    axis = model_axis(ctx)
    if axis is not None:
        x = axis.copy(x)
    h = F.silu(torch.einsum("bsd,df->bsf", x, p["w_gate"])) \
        * torch.einsum("bsd,df->bsf", x, p["w_up"])
    out = torch.einsum("bsf,fd->bsd", h, p["w_down"])
    return out if axis is None else axis.reduce(out)


# ---------------------------------------------------------------------------
# Mixture of Experts (every expert local, or expert-parallel over a model
# axis)
# ---------------------------------------------------------------------------

def init_moe(gen: torch.Generator, cfg: ModelConfig, dtype, device=None,
             layers: tuple = ()) -> PyTree:
    """The router (f32 in every model dtype), the experts' stacked SwiGLU
    weights ``(E, D, F)``/``(E, F, D)`` and, when ``cfg.shared_expert``, a
    ``shared`` MLP of ``d_ff``."""
    D, F_, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    L = tuple(layers)
    p = {
        "router": dense_init(gen, L + (D, E), D, torch.float32, device),
        "w_gate_experts": dense_init(gen, L + (E, D, F_), D, dtype, device),
        "w_up_experts": dense_init(gen, L + (E, D, F_), D, dtype, device),
        "w_down_experts": dense_init(gen, L + (E, F_, D), F_, dtype, device),
    }
    if cfg.shared_expert:
        p["shared"] = init_mlp(gen, D, F_, dtype, device, L)
    return p


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest entries of each row of ``x`` and their indices,
    largest first and, among equal values, the lower index first (the
    order of ``jax.lax.top_k``; ``torch.topk`` gives ties in no set order
    on CUDA). A stable descending sort of the whole row."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_capacity(n: int, cfg: ModelConfig) -> int:
    """Tokens each expert takes of ``n``: ``ceil(n k / E x
    capacity_factor)``, at least 1 and at most ``n`` (a decode step of B
    tokens at top-8 of 128 experts gives every expert one)."""
    c = max(1, int(math.ceil(n * cfg.top_k / cfg.n_experts
                             * cfg.capacity_factor)))
    return min(c, n)


def _experts(xe, wg, wu, wd):
    """The experts' SwiGLU products of their gathered tokens xe: (E, C,
    D) -> (E, C, D) in the model dtype, as batched matmuls. The weights
    are the ``(E, D, F)``/``(E, F, D)`` stacks or the per-layer layout's
    ``(E·D, F)``/``(E·F, D)`` leaves (:func:`split_layers`), viewed as the
    stacks: the same kernels and bits either way, no copy."""
    E = xe.shape[0]
    wg, wu, wd = (w.view(E, -1, w.shape[-1]) for w in (wg, wu, wd))
    h = F.silu(torch.bmm(xe, wg)) * torch.bmm(xe, wu)
    return torch.bmm(h, wd)


def moe_route(x, router, cfg: ModelConfig, capacity: int, *,
              E_local: Optional[int] = None, e_offset: int = 0, axis=None):
    """The routing of ``_moe_body``: the router's f32 ``logits`` and
    ``probs`` (N, E), each token's top-k experts ``sel`` (N, k), the dense
    normalised gate weights ``w_full`` (N, E) and, for experts ``e_offset
    .. e_offset + E_local`` (default: all), each one's top-``capacity``
    tokens ``idx`` (E_local, C) with their weights ``vals``. On a model
    ``axis`` the local experts' columns are read through ``axis.copy``, so
    the gate weights' gradient is summed over the axis' experts."""
    E, k = cfg.n_experts, cfg.top_k
    E_l = E if E_local is None else E_local
    N = x.shape[0]
    logits = x.to(torch.float32) @ router                 # (N, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, sel = top_k(probs, k)                       # (N, k)
    gate_vals = gate_vals / torch.sum(gate_vals, dim=-1, keepdim=True)
    w_full = torch.zeros((N, E), dtype=torch.float32, device=x.device)
    w_full.scatter_(1, sel, gate_vals)
    w_local = w_full if axis is None else axis.copy(w_full)
    if E_l != E:
        w_local = w_local[:, e_offset:e_offset + E_l]
    vals, idx = top_k(w_local.t(), capacity)               # (E_l, C)
    return logits, probs, sel, w_full, vals, idx


def _moe_body(x, router, wg, wu, wd, *, cfg: ModelConfig, capacity: int,
              E_local: Optional[int] = None, e_offset: int = 0, axis=None):
    """Token-choice top-k routing, per-expert top-``capacity`` gather.

    x: (N, D) tokens; wg/wu/wd: the stacks of experts ``e_offset ..
    e_offset + E_local`` (default: every expert), 3-D or held 2-D
    (:func:`_experts`). Returns (out (N, D) f32: the local experts' part
    of the combine, lb_loss, z_loss). Each expert takes the ``capacity``
    tokens of largest combine weight (ties: the lower token first, so the
    same tokens are dropped as in the reference); its products run in the
    model dtype. The combine gathers each token's routed local expert rows
    and adds them in expert order, 0 for a dropped one: no atomics, the
    same bits on every run (an ``index_add_`` on CUDA adds in no fixed
    order). A token that an expert took with weight 0 adds 0, as in the
    reference's scatter-add. On a model ``axis`` (expert parallelism) the
    tokens enter the expert gather through ``axis.copy`` and the caller
    sums ``out`` over the axis; the router and the aux losses are computed
    whole on every rank.

    The gradient flows as under ``jax.grad`` of the reference: through the
    normalised gates (their sort and the scatter into the dense weights),
    the experts' top-capacity weights, the token gather and the combine's
    row gathers, into x, the router and the experts; never into an index,
    and the load-balance loss's dispatch fractions carry none.
    """
    N, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    E_l = E if E_local is None else E_local
    logits, probs, sel, w_full, vals, idx = moe_route(
        x, router, cfg, capacity, E_local=E_local, e_offset=e_offset,
        axis=axis)
    xe = (x if axis is None else axis.copy(x))[idx]        # (E_l, C, D)
    he = _experts(xe, wg, wu, wd).to(torch.float32) * vals[..., None]
    # each routed (token, local expert)'s row in he, or -1 where it was
    # dropped or the expert is another rank's
    slot = torch.full((E_l, N), -1, dtype=torch.int64, device=x.device)
    slot.scatter_(1, idx, torch.arange(capacity, device=x.device)
                  .expand(E_l, capacity).contiguous())
    sel, _ = torch.sort(sel, dim=-1)                       # expert order
    if E_l == E:
        pos = torch.gather(slot, 0, sel.t()).t()           # (N, k)
    else:
        sel = sel - e_offset
        mine = (sel >= 0) & (sel < E_l)
        sel = sel.clamp(0, E_l - 1)
        pos = torch.where(mine, torch.gather(slot, 0, sel.t()).t(), -1)
    rows = he.reshape(E_l * capacity, D)
    out = torch.zeros((N, D), dtype=torch.float32, device=x.device)
    for j in range(k):
        got = pos[:, j] >= 0
        r = rows[(sel[:, j] * capacity + pos[:, j]).clamp_min(0)]
        out = out + torch.where(got[:, None], r, 0.0)
    # router aux losses (load balance + z-loss), as the reference's
    me = torch.mean(probs, dim=0)
    ce = torch.mean((w_full > 0).to(torch.float32), dim=0)
    lb_loss = E * torch.sum(me * ce)
    z_loss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return out, lb_loss, z_loss


def moe_block(x, p, cfg: ModelConfig, ctx=None):
    """x: (B, S, D) -> ((B, S, D) in x's dtype, (lb_loss, z_loss)), the
    shared expert added when the config has one. Without a model axis
    every expert runs here on the B x S tokens. On one (``ctx``) this rank
    holds ``E / tp`` experts at offset ``pos · E / tp`` (``p``'s expert
    stacks are its slices), x is its data shard, the capacity is that of
    the shard's tokens, and the combine is summed over the axis: an
    all-reduce, or under ``cfg.moe_reduce_scatter`` (when ``tp`` divides S
    and S > 1) a reduce-scatter over S then an all-gather, the same bits.
    The aux losses are the data shard's own."""
    B, S, D = x.shape
    n = B * S
    axis = model_axis(ctx)
    if axis is None:
        out, lb, zl = _moe_body(x.reshape(n, D), p["router"],
                                p["w_gate_experts"], p["w_up_experts"],
                                p["w_down_experts"], cfg=cfg,
                                capacity=moe_capacity(n, cfg))
        out = out.reshape(B, S, D).to(x.dtype)
    else:
        E_l = cfg.n_experts // axis.size
        out, lb, zl = _moe_body(x.reshape(n, D), p["router"],
                                p["w_gate_experts"], p["w_up_experts"],
                                p["w_down_experts"], cfg=cfg,
                                capacity=moe_capacity(n, cfg), E_local=E_l,
                                e_offset=axis.pos * E_l, axis=axis)
        rs = cfg.moe_reduce_scatter and S % axis.size == 0 and S > 1
        out = axis.reduce(out.reshape(B, S, D), dtype=x.dtype,
                          scatter_dim=1 if rs else None)
    if cfg.shared_expert:
        out = out + mlp_block(x, p["shared"], ctx)
    return out, (lb, zl)


# ---------------------------------------------------------------------------
# embedding + LM head
# ---------------------------------------------------------------------------

def init_embed(gen: torch.Generator, cfg: ModelConfig, dtype,
               device=None) -> PyTree:
    p = {"embed": dense_init(gen, (cfg.vocab, cfg.d_model), cfg.d_model,
                             dtype, device)}
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, (cfg.vocab, cfg.d_model), cfg.d_model,
                                  dtype, device)
    return p


def embed_tokens(tokens: torch.Tensor, p, ctx=None) -> torch.Tensor:
    """Token embedding lookup: a plain gather (its gradient is the
    scatter-add of the rows back into the table). On a model axis this
    rank's ``embed`` is its block of the vocab: each token's row where the
    rank holds it, zeros elsewhere, summed over the axis (the reference's
    one-hot matmul, exactly: one term of each sum is not zero)."""
    axis = model_axis(ctx)
    emb = p["embed"]
    if axis is None:
        return emb[tokens.long()]
    V_l = emb.shape[0]
    local = tokens.long() - axis.pos * V_l
    inside = (local >= 0) & (local < V_l)
    rows = emb[local.clamp(0, V_l - 1)]
    rows = torch.where(inside[..., None], rows,
                       torch.zeros((), dtype=rows.dtype, device=rows.device))
    return axis.reduce(rows)


def lm_logits(h: torch.Tensor, p, ctx=None) -> torch.Tensor:
    """(B, S, D) -> (B, S, V) f32 logits through the LM head (the
    embedding when tied). On a model axis each rank computes its block of
    the vocab and the blocks are all-gathered (forward only: serving)."""
    head = p.get("lm_head", p["embed"])
    axis = model_axis(ctx)
    if axis is not None:
        h = h.detach()
    logits = torch.einsum("bsd,vd->bsv", h.to(torch.float32),
                          head.to(torch.float32))
    if axis is None:
        return logits
    parts = axis.comm.all_gather(logits.movedim(-1, 0).contiguous(),
                                 name="lm_logits")
    return parts.view((-1,) + logits.shape[:-1]).movedim(0, -1)


def _chunk_loss(hx, yx, mx, head):
    """One chunk's summed masked cross-entropy and its mask count, from
    f32 logits of the f32 head."""
    logits = torch.einsum("bcd,vd->bcv", hx.to(torch.float32),
                          head.to(torch.float32))
    nll = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                          yx.reshape(-1).long(), reduction="none")
    return torch.sum(nll * mx.reshape(-1)), torch.sum(mx)


def _chunk_loss_vocab(hx, yx, mx, head, axis):
    """:func:`_chunk_loss` over this rank's block of the vocab: the
    logsumexp from the blocks' maximum (no gradient) and their summed
    exponentials, the label's logit from the block that holds it (zeros
    elsewhere), both sums in one reduction over the axis."""
    logits = torch.einsum("bcd,vd->bcv", hx.to(torch.float32),
                          head.to(torch.float32))
    V_l = logits.shape[-1]
    m = axis.maxed(torch.amax(logits, dim=-1))
    local = yx.long() - axis.pos * V_l
    inside = (local >= 0) & (local < V_l)
    ll = torch.gather(logits, -1, local.clamp(0, V_l - 1)[..., None])[..., 0]
    ll = torch.where(inside, ll, torch.zeros((), device=ll.device))
    se = torch.sum(torch.exp(logits - m[..., None]), dim=-1)
    both = axis.reduce(torch.stack([se, ll]))
    nll = m + torch.log(both[0]) - both[1]
    return torch.sum(nll * mx), torch.sum(mx)


def loss_mask(batch: dict) -> torch.Tensor:
    """``batch``'s f32 loss mask: its ``mask``, or ones over ``labels``."""
    mask = batch.get("mask")
    if mask is None:
        labels = batch["labels"]
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=labels.device)
    return mask


def lm_loss_chunked(h, p, labels, mask, cfg: ModelConfig,
                    ctx=None) -> torch.Tensor:
    """Next-token cross-entropy without holding (B, S, V) logits.

    h: (B,S,D); labels/mask: (B,S). Walks S in chunks of the reference's
    size (``cfg.loss_chunk`` tokens per 8 sequences, at least 128),
    keeping the batch dim; each chunk's (B, chunk, V) f32 logits are
    recomputed in backward, never saved (``torch.utils.checkpoint``). On a
    model axis each rank's logits are its block of the vocab
    (:func:`_chunk_loss_vocab`). Returns the mean over the mask's tokens,
    f32.
    """
    B, S, D = h.shape
    head = p.get("lm_head", p["embed"])
    axis = model_axis(ctx)
    if axis is None:
        fn, extra = _chunk_loss, ()
    else:
        fn, extra = _chunk_loss_vocab, (axis,)
        h = axis.copy(h)
    C = min(max(cfg.loss_chunk // max(B // 8, 1), 128), S)
    while S % C:
        C //= 2
    C = max(C, 1)
    mf = mask.to(torch.float32)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    count = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(S // C):
        sl = slice(c * C, (c + 1) * C)
        if torch.is_grad_enabled():
            loss, cnt = torch.utils.checkpoint.checkpoint(
                fn, h[:, sl], labels[:, sl], mf[:, sl], head, *extra,
                use_reentrant=False, preserve_rng_state=False)
        else:
            loss, cnt = fn(h[:, sl], labels[:, sl], mf[:, sl], head, *extra)
        total = total + loss
        count = count + cnt
    return total / torch.clamp_min(count, 1.0)
