"""Minimal functional optimizers, the port of ``repro.optim.optimizers``.

Each optimizer is ``init(params) -> state`` and ``update(grads, state,
params) -> (new_params, new_state)`` over a tree of tensors; the moments
mirror the parameter tree, in ``moment_dtype`` (f32 unless asked
otherwise) whatever the parameters' dtype, and ``state.step`` is a 0-d
int32 tensor on the parameters' device.

Every optimizer here is elementwise: one per-tensor function,
``optimizer.elementwise(p, g, moments, step) -> (p', moments')``, is the
whole update, and the tree update is that function leaf by leaf.
:func:`arena_apply` runs the same function over the flat word arena
(:mod:`repro_torch.core.arena`) in place, a slice at a time, so the arena
path's stored parameters and moments equal the tree path's bit for bit:
the elementwise arithmetic is the same, only the slicing differs. For an
all-f32 layout the update runs on a float view of the arena words; for
other layouts each slice is decoded to f32 values, updated and re-encoded
through its stored dtype (the tree path's ``.to(p.dtype)`` rounding).
This in-place apply takes the place of the reference's donated arena.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.utils.tree import tree_flatten, tree_map, tree_unflatten

PyTree = Any

# values per slice of the in-place arena apply: its f32 temporaries stay a
# few hundred MB at any model size (a multiple of 4, so a slice of a
# sub-word run starts and ends on a word)
APPLY_SLICE = 1 << 25


class OptState(NamedTuple):
    step: torch.Tensor
    mu: PyTree        # first moment (or momentum buffer); () for sgd
    nu: PyTree        # second moment; () for sgd and momentum


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[PyTree], OptState]
    update: Callable[[PyTree, OptState, PyTree], tuple[PyTree, OptState]]
    name: str = "opt"
    # (p, g, moments tuple, new step) -> (p', moments'): the per-tensor
    # update that ``update`` maps over the tree and arena_apply over slices
    elementwise: Callable = None
    n_moments: int = 0


def _first(tree: PyTree) -> torch.Tensor:
    return tree_flatten(tree)[0][0]


def _zeros_like(params: PyTree, dtype: torch.dtype) -> PyTree:
    return tree_map(lambda x: torch.zeros(x.shape, dtype=dtype,
                                          device=x.device), params)


def _step0(params: PyTree) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=_first(params).device)


def _make(name: str, n_moments: int, elementwise: Callable,
          moment_dtype: torch.dtype = torch.float32) -> Optimizer:
    def init(params):
        moments = [_zeros_like(params, moment_dtype)
                   for _ in range(n_moments)]
        moments += [()] * (2 - n_moments)
        return OptState(_step0(params), *moments)

    def update(grads, state, params):
        t = state.step + 1
        p_leaves, treedef = tree_flatten(params)
        g_leaves = tree_flatten(grads)[0]
        m_leaves = [tree_flatten(m)[0] for m in (state.mu, state.nu)
                    [:n_moments]]
        new_p, new_m = [], [[] for _ in range(n_moments)]
        for i, (p, g) in enumerate(zip(p_leaves, g_leaves)):
            q, ms = elementwise(p, g, tuple(m[i] for m in m_leaves), t)
            new_p.append(q)
            for k in range(n_moments):
                new_m[k].append(ms[k])
        moments = [tree_unflatten(treedef, m) for m in new_m]
        moments += [()] * (2 - n_moments)
        return tree_unflatten(treedef, new_p), OptState(t, *moments)

    return Optimizer(init, update, name, elementwise, n_moments)


def sgd(lr: float) -> Optimizer:
    def elementwise(p, g, moments, t):
        out = p.to(torch.float32) - lr * g.to(torch.float32)
        return out.to(p.dtype), ()
    return _make("sgd", 0, elementwise)


def momentum(lr: float, beta: float = 0.9) -> Optimizer:
    def elementwise(p, g, moments, t):
        mu = beta * moments[0] + g.to(torch.float32)
        out = p.to(torch.float32) - lr * mu
        return out.to(p.dtype), (mu,)
    return _make("momentum", 1, elementwise)


def adam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         moment_dtype: torch.dtype = torch.float32) -> Optimizer:
    return _adam_like(lr, b1, b2, eps, wd=0.0, name="adam",
                      moment_dtype=moment_dtype)


def adamw(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          wd: float = 0.01, moment_dtype: torch.dtype = torch.float32
          ) -> Optimizer:
    # moment_dtype=torch.bfloat16 halves the optimizer state's memory
    return _adam_like(lr, b1, b2, eps, wd=wd, name="adamw",
                      moment_dtype=moment_dtype)


def _adam_like(lr, b1, b2, eps, wd, name,
               moment_dtype=torch.float32) -> Optimizer:
    def elementwise(p, g, moments, t):
        # f32 bias corrections of the new step count, on the device
        tf = t.to(torch.float32)
        bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                         device=tf.device), tf)
        bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                         device=tf.device), tf)
        gf = g.to(torch.float32)
        m, v = moments
        m = (b1 * m.to(torch.float32) + (1 - b1) * gf).to(moment_dtype)
        v = (b2 * v.to(torch.float32)
             + (1 - b2) * torch.square(gf)).to(moment_dtype)
        mf, vf = m.to(torch.float32), v.to(torch.float32)
        step = lr * (mf / bc1) / (torch.sqrt(vf / bc2) + eps)
        pf = p.to(torch.float32)
        out = pf - step
        if wd:
            out = out - lr * wd * pf
        return out.to(p.dtype), (m, v)
    return _make(name, 2, elementwise, moment_dtype)


# ---------------------------------------------------------------------------
# arena-native apply (the flat word arena as the live parameters)
# ---------------------------------------------------------------------------

def arena_apply(optimizer: Optimizer, grads: torch.Tensor, state: OptState,
                arena: torch.Tensor, layout, runs=None
                ) -> tuple[torch.Tensor, OptState]:
    """One optimizer step over the flat word arena, in place.

    ``arena`` is the ``(total_words,)`` int32 word buffer laid out by
    ``layout`` (:class:`repro_torch.core.arena.ArenaLayout`); ``grads`` and
    ``state``'s moment buffers live in the f32 value domain
    (``(total_values,)``; ``optimizer.init`` on a value-shaped zeros
    buffer). Each coalesced same-dtype run is walked in slices of
    ``APPLY_SLICE`` values: decode the slice's words to f32 values, run
    ``optimizer.elementwise`` on it, write the moments back into their
    buffers and the re-encoded values back into the arena words. Pad
    words stay zero: zero grads give zero moments and a zero step, weight
    decay of 0 is 0 (invariant I4), and sub-word element pads decode to
    0.0 and re-encode to zero bits. Returns ``(arena, new_state)``; the
    arena and the moment buffers are the ones given, updated. ``runs``
    (default ``layout.value_runs()``) says where the runs lie: a rank's
    shard on a mesh passes its span's (``layout.span_runs``)."""
    from repro_torch.core.arena import decode_words, encode_words

    t = state.step + 1
    n = optimizer.n_moments
    moments = (state.mu, state.nu)[:n]
    for w0, nw, v0, nv, dt in (layout.value_runs() if runs is None
                                else runs):
        r = nv // nw
        for a in range(0, nv, APPLY_SLICE):
            b = min(a + APPLY_SLICE, nv)
            words = arena[w0 + a // r:w0 + b // r]
            p = decode_words(words, dt)
            q, ms = optimizer.elementwise(
                p, grads[v0 + a:v0 + b],
                tuple(m[v0 + a:v0 + b] for m in moments), t)
            for m, new in zip(moments, ms):
                m[v0 + a:v0 + b].copy_(new)
            words.copy_(encode_words(q, dt))
    return arena, OptState(t, *moments, *([()] * (2 - n)))
