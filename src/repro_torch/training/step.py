"""Train-step builders of the LM trainer, the port of
``repro.training.step``.

``make_train_step`` is the PyTree step. ``make_arena_train_step`` is its
arena-native twin: the live parameters enter and leave the step as the
flat word arena (:mod:`repro_torch.core.arena`), decoded at the top of the
step into leaf-shaped tensors that require grad (views of the arena where
a leaf's payload fills its segments), laid out as the PyTree path's
leaves (so both paths hand the same operands to the same GEMMs), the loss
and its gradient taken with respect to that tree (NOT through the decode:
differentiating through it would scatter each leaf into a full-arena
gradient), the gradient packed to the f32 value domain
(``pack_values``), and the optimizer run over the arena in place
(:func:`repro_torch.optim.optimizers.arena_apply`).

Both steps accumulate microbatched gradients (``cfg.microbatch > 1``):
the global batch is split into MB microbatches run in turn, their
gradients summed in ``cfg.opt_moment_dtype`` and divided by MB; the loss
is the microbatches' mean. The arena step adds each microbatch's gradient
into its value-domain accumulator leaf by leaf and divides it in place
(:func:`repro_torch.core.arena.accumulate_values`), the same elementwise
arithmetic as the tree path's. Its accumulator, one ``(total_values,)``
buffer (on a mesh, the rank's span), is allocated at the first
step and cleared in place at every
later one, until the step's ``release()`` lets it go (``TrainLoop.run``
calls it as it returns): a new buffer a step (11.9 GB for one
internvl2-76b layer) lets the caching allocator's segments fragment
until it finds no room.

A step returns ``(new_state, loss)`` with the loss a 0-d f32 tensor on
the device (reading it waits for the step).

**On a mesh** (``comm``, a :class:`~repro_torch.distributed.collectives.
MeshComm`) each rank computes the loss of its slice of the global batch
and holds only its span of the arena and of its moments. A step runs on
the rank's model slices alone, one group of them at a time (the plan of
:class:`~repro_torch.sharding.partition.SlicePlan`, built once with the
step: a group a layer the model recomputes in backward, ``cfg.remat``,
and the outer group of every other leaf). ``slice_gather`` brings a
group's words from their owners' spans into a slice-domain buffer of the
group, which decodes to slice-shaped leaves without a copy. The outer
group (the embedding, the head, the final norms, a VLM's projector, the
hybrid's shared block, the encoder-decoder's encoder) is gathered once
and held for the step; each layer is a
:class:`~repro_torch.models.layers.GatheredLayer`, whose
``layers.layer_call`` gathers the layer's slices as the layer starts,
under remat: in the forward, whose graph keeps none of them, and again
in the recompute in backward. Once the backward has the gradient of
every slice of the layer it packs it into the group's slice domain and
reduces it into the rank's span gradient before it moves on; the outer
group's gradient is reduced when the backward ends. ``slice_reduce``
sends each word's gradient to the owner of its span, which adds the
contributions in mesh position order and divides by the number of batch
shards (the mean of the shards' gradients), and the optimizer runs over
the span in place. No rank holds a buffer of all its slices, nor of the
whole arena: at most the outer group, one layer's slices and their
gradient, the span gradient and the remat checkpoints. Every rank runs
its layers in the same order, so the exchanges line up. The loss is the
mean of the shards' losses.

At ``cfg.microbatch == 1`` each word's gradient is the sum of the same
contributors in the same order as when the rank's slices were gathered
whole for the step: the same bits. Microbatched, the sum runs in the
reference's order (``repro.training.step``, whose microbatch loop packs
each gradient to the flat sharding and adds it into a span-sized
accumulator): each microbatch's gradient is reduced, divided by the
shards and added, in f32 and rounded, into a span accumulator in
``cfg.opt_moment_dtype``, which is divided by the microbatches at the
end. The accumulator and the microbatch's span are made at the first
step and reused until ``release()``.

Where the forward is model-parallel (``ctx``: a mesh whose ``model`` axis
has ``tp > 1`` positions) the batch shards are the data positions, each
shared by the ``tp`` ranks of its model line, and a rank's slices are
its cuts of each leaf (:func:`~repro_torch.sharding.partition.
model_slices`). A word's gradient comes from every data position and,
of a model line, from the positions whose slice covers it: a cut leaf
counts on every rank whose slice covers the word, also where the slices
overlap (a kv head shared by several positions, a Mamba2 ``in_proj``'s B
and C columns, each rank's part the gradient of its own heads); a leaf
every rank computes whole (the router, an embedding whose vocab does not
split, a VLM's projector) counts at the line's first rank (model
position 0) alone. The stacks' norms count on every rank of the line:
where a stack keeps its carry S-sharded over the line (Megatron SP,
``models.layers.seq_axis``) each rank applies them to its piece of S,
and where it keeps it replicated the forward keeps their gradient at
position 0 alone (``ModelAxis.once``). One divisor, the data positions,
makes the mean. The loss, the
same on every rank of a line, is counted at model position 0 alone. A
``(n, 1)`` mesh (the survivor mesh) has ``tp = 1``: every slice is the
whole leaf, so each layer is gathered whole over the data line as it
runs, and every rank runs the whole forward on its own rows.

The PyTree step on a mesh keeps its whole tree on every rank: it takes
each group's slices of the tree (:meth:`SlicePlan.take`) where the arena
step gathers them, and runs the same gradient and the same reduces, then
all-gathers the reduced spans and updates the tree in place, slice by
slice (the arena path's apply does the same; out of place, a full-width
tree, its moments and their new copies do not fit four ranks on one
card), so the two paths stay bit-equal on one mesh. A one-rank mesh is
the single-device step bit for bit.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.arena import (accumulate_values, pack_values,
                                    unpack_arena)
from repro_torch.data.pipeline import data_shard, model_parallel
from repro_torch.models.api import ModelOps
from repro_torch.models.layers import GatheredLayer, torch_dtype
from repro_torch.optim.optimizers import (APPLY_SLICE, Optimizer, OptState,
                                          arena_apply)
from repro_torch.sharding.partition import (OUTER, SlicePlan,
                                            acts_on_pieces, model_slices,
                                            take_model_slices)
from repro_torch.training.train_state import ArenaTrainState, TrainState
from repro_torch.utils.tree import (flatten_with_path, keystr, tree_flatten,
                                    tree_map, tree_unflatten)

PyTree = Any


def _grad_leaves(ops: ModelOps, cfg: ModelConfig, params: PyTree,
                 batch: dict, ctx=None) -> tuple[torch.Tensor, list, Any]:
    """The loss of ``batch`` and its gradient with respect to every leaf of
    ``params``, as a list in leaf order (leaves the loss does not reach
    get zeros), and the tree's structure. The leaves are taken as they
    are (aliases that require grad; nothing is copied). With a
    model-parallel ``ctx`` the loss runs on this rank's model slices,
    taken as views of the whole leaves ``params``, and a leaf computed
    whole keeps its gradient at model position 0 only, but the stacks'
    norms (``partition.acts_on_pieces``), each rank's part of their sum."""
    leaves, treedef = tree_flatten(params)
    leaves = [x.detach().requires_grad_(True) for x in leaves]
    tree = tree_unflatten(treedef, leaves)
    with torch.enable_grad():
        if ctx is None:
            loss = ops.train_loss(tree, batch, cfg)
        else:
            slices = model_slices(tree, ctx)
            loss = ops.train_loss(take_model_slices(tree, slices), batch,
                                  cfg, ctx=ctx)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    del tree
    grads = [torch.zeros_like(x) if g is None else g
             for x, g in zip(leaves, grads)]
    if ctx is not None and ctx.mesh.axis_position(ctx.tp) != 0:
        for g, (path, s) in zip(grads, flatten_with_path(slices)[0]):
            if not s and not acts_on_pieces(keystr(path)):
                g.zero_()
    return loss.detach(), grads, treedef


def loss_and_grad(ops: ModelOps, cfg: ModelConfig, params: PyTree,
                  batch: dict, ctx=None) -> tuple[torch.Tensor, PyTree]:
    """The loss of ``batch`` and its gradient tree (:func:`_grad_leaves`)."""
    loss, grads, treedef = _grad_leaves(ops, cfg, params, batch, ctx)
    return loss, tree_unflatten(treedef, grads)


def _microbatches(batch: dict, mb: int) -> list[dict]:
    return [{k: v.reshape((mb, v.shape[0] // mb) + tuple(v.shape[1:]))[i]
             for k, v in batch.items()} for i in range(mb)]


def _mesh_terms(cfg: ModelConfig, comm, ctx):
    """The model-parallel ctx of a step on ``comm``'s mesh (None when the
    forward is not split over a ``model`` axis) and the number of batch
    shards its gradient and loss are averaged over."""
    if comm is None:
        return None, 1
    tp_ctx = ctx if model_parallel(cfg, ctx) else None
    if tp_ctx is None:
        return None, comm.n
    return tp_ctx, data_shard(comm.mesh, True)[0]


def _mean_loss(loss: torch.Tensor, comm, tp_ctx, shards: int
               ) -> torch.Tensor:
    """The batch shards' mean loss (the loss itself on one rank): each
    shard's loss counted once, at model position 0 of its line."""
    if comm is None or comm.n == 1:
        return loss
    mine = loss.reshape(1).clone()
    if tp_ctx is not None and tp_ctx.mesh.axis_position(tp_ctx.tp) != 0:
        mine.zero_()
    return comm.all_reduce(mine)[0] / shards


def _mesh_grads(ops: ModelOps, cfg: ModelConfig, plan, comm, gather,
                batch: dict, tp_ctx, shards: int, bufs: list
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The loss of this rank's ``batch`` and its span of the batch shards'
    mean gradient, group by group of ``plan`` (see the module docstring):
    ``gather(g)`` returns a new slice-domain buffer of group ``g``'s
    slices; the outer group's is held for the step, each layer's is
    gathered by its :class:`~repro_torch.models.layers.GatheredLayer` as
    the layer runs, and each group's gradient reduced into the span as
    the backward leaves it. Microbatched, ``bufs`` holds the span
    accumulator (``cfg.opt_moment_dtype``) and a microbatch's f32 span,
    made at the first call and reused."""
    f32 = torch.float32
    m = plan.model
    mb = max(cfg.microbatch, 1)
    outer = [x.detach().requires_grad_(True) for x in plan.decode(
        gather(OUTER).view(f32), OUTER)]
    dev = outer[0].device
    # the gathered layers' common input: asking its gradient makes the
    # backward run each layer's gather node, which sends the layer's
    # gradient to its owners
    anchor = torch.zeros((), dtype=f32, device=dev, requires_grad=True)
    if mb == 1:
        span = torch.zeros((plan.shard_words,), dtype=f32, device=dev)
    else:
        if not bufs:
            bufs += [torch.zeros((plan.shard_words,), device=dev,
                                 dtype=torch_dtype(cfg.opt_moment_dtype)),
                     torch.empty((plan.shard_words,), dtype=f32,
                                 device=dev)]
        acc, span = bufs
        acc.zero_()

    def send(g: int, grads: list) -> None:
        buf = plan.pack(torch.empty((plan.group_values(g, m),), dtype=f32,
                                    device=dev), grads, g)
        comm.slice_reduce(buf, plan, g, out=span)

    def layer(g: int) -> GatheredLayer:
        return GatheredLayer(
            lambda: plan.decode(gather(g).view(f32), g),
            lambda grads: send(g, grads), plan.group_treedefs[g], anchor)
    tree = plan.model_tree(outer, layer)
    kw = {} if tp_ctx is None else {"ctx": tp_ctx}
    losses = []
    for bx in [batch] if mb == 1 else _microbatches(batch, mb):
        if mb > 1:
            span.zero_()
        with torch.enable_grad():
            loss = ops.train_loss(tree, bx, cfg, **kw)
            got = torch.autograd.grad(loss, outer + [anchor],
                                      allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for x, g in zip(outer, got)]
        del got
        send(OUTER, grads)
        losses.append(loss.detach())
        if shards > 1:
            span.div_(shards)
        if mb > 1:
            # the reference's order: the microbatch's mean over the
            # shards added into the accumulator, in f32, rounded to its
            # dtype
            for a in range(0, acc.numel(), APPLY_SLICE):
                x, y = acc[a:a + APPLY_SLICE], span[a:a + APPLY_SLICE]
                if acc.dtype == f32:
                    x.add_(y)
                else:
                    x.copy_(x.to(f32) + y)
    del tree, outer
    if mb == 1:
        return losses[0], span
    loss_sum = 0.0
    for loss in losses:
        loss_sum = loss_sum + loss
    acc.div_(mb)              # in the accumulator's dtype, as the tree
    return loss_sum / mb, acc


def _plan(ops: ModelOps, cfg: ModelConfig, layout, comm, tp_ctx):
    """The mesh step's :class:`SlicePlan` (None off a mesh): a group a
    layer the model recomputes in backward (``cfg.remat``)."""
    if comm is None:
        return None
    return SlicePlan(layout, comm.mesh, tp_ctx,
                     ops.remat_layers if cfg.remat else ())


def _update_in_place(optimizer: Optimizer, grads: PyTree,
                     state: TrainState) -> OptState:
    """``optimizer.update`` with every leaf and moment written in place,
    ``APPLY_SLICE`` values at a time (the same elementwise arithmetic, so
    the same bits). Returns the new optimizer state."""
    t = state.opt_state.step + 1
    n = optimizer.n_moments
    p_leaves = tree_flatten(state.params)[0]
    g_leaves = tree_flatten(grads)[0]
    m_leaves = [tree_flatten(m)[0] for m in (state.opt_state.mu,
                                             state.opt_state.nu)[:n]]
    for i, (p, g) in enumerate(zip(p_leaves, g_leaves)):
        pf, gf = p.view(-1), g.reshape(-1)
        ms = [m[i].view(-1) for m in m_leaves]
        for a in range(0, pf.numel(), APPLY_SLICE):
            b = min(a + APPLY_SLICE, pf.numel())
            q, new = optimizer.elementwise(
                pf[a:b], gf[a:b], tuple(m[a:b] for m in ms), t)
            pf[a:b].copy_(q)
            for m, x in zip(ms, new):
                m[a:b].copy_(x)
    st = state.opt_state
    return OptState(t, st.mu, st.nu)


def make_train_step(ops: ModelOps, cfg: ModelConfig, optimizer: Optimizer,
                    layout=None, comm=None, ctx=None):
    """The PyTree step: ``(TrainState, batch) -> (TrainState', loss)``.
    On a mesh (``comm``, and its ``ctx``) the gradient of the rank's
    slices is reduced into its span of the arena ``layout`` and gathered
    back (see the module docstring)."""
    tp_ctx, shards = _mesh_terms(cfg, comm, ctx)
    plan = _plan(ops, cfg, layout, comm, tp_ctx)

    def train_step(state: TrainState, batch: dict):
        if comm is not None:
            loss, span = _mesh_grads(
                ops, cfg, plan, comm, lambda g: plan.take(state.params, g),
                batch, tp_ctx, shards, [])
            grads = unpack_arena(comm.all_gather(span.to(torch.float32))
                                 .view(torch.int32), layout, copy=False)
            del span
            loss = _mean_loss(loss, comm, tp_ctx, shards)
            opt_state = _update_in_place(optimizer, grads, state)
            return TrainState(state.params, opt_state, state.step + 1), loss
        mb = max(cfg.microbatch, 1)
        if mb == 1:
            loss, grads = loss_and_grad(ops, cfg, state.params, batch)
        else:
            acc_dtype = torch_dtype(cfg.opt_moment_dtype)
            gacc = tree_map(lambda p: torch.zeros(
                p.shape, dtype=acc_dtype, device=p.device), state.params)
            loss_sum = 0.0
            for bx in _microbatches(batch, mb):
                l, g = loss_and_grad(ops, cfg, state.params, bx)
                gacc = tree_map(lambda a, x: (a.to(torch.float32)
                                              + x.to(torch.float32)
                                              ).to(a.dtype), gacc, g)
                loss_sum = loss_sum + l
            loss = loss_sum / mb
            grads = tree_map(lambda g: g / mb, gacc)
        params, opt_state = optimizer.update(grads, state.opt_state,
                                             state.params)
        return TrainState(params, opt_state, state.step + 1), loss

    return train_step


def make_arena_train_step(ops: ModelOps, cfg: ModelConfig,
                          optimizer: Optimizer, layout, comm=None, ctx=None):
    """The arena-native step: ``(ArenaTrainState, batch) -> (state',
    loss)``, the arena and the moment buffers updated in place (on a mesh,
    ``comm``: the rank's spans of them).

    Bit-equal to the PyTree step: the decoded leaves hold the tree path's
    values in its layout, ``pack_values`` of the grads is the f32 image of
    the values the tree optimizer reads, and the flat apply is the same
    elementwise arithmetic, re-encoded through each leaf's stored dtype as
    the tree path's ``.to(p.dtype)``."""
    acc: list = []          # the microbatched step's accumulator, reused
    tp_ctx, shards = _mesh_terms(cfg, comm, ctx)
    plan = _plan(ops, cfg, layout, comm, tp_ctx)

    def train_step(state: ArenaTrainState, batch: dict):
        if comm is not None:
            loss, grads = _mesh_grads(
                ops, cfg, plan, comm, lambda g: comm.slice_gather(
                    state.arena, plan, g), batch, tp_ctx, shards, acc)
            loss = _mean_loss(loss, comm, tp_ctx, shards)
            arena, opt_state = arena_apply(
                optimizer, grads, state.opt_state, state.arena, layout,
                runs=layout.span_runs(comm.pos))
            return ArenaTrainState(arena, opt_state, state.step + 1,
                                   state.layout), loss
        # views of the arena where they can be: nothing writes it before
        # the apply below, after the last microbatch's backward
        params = unpack_arena(state.arena, layout, copy=False)
        mb = max(cfg.microbatch, 1)
        if mb == 1:
            loss, g = loss_and_grad(ops, cfg, params, batch)
            del params
            grads = pack_values(g, layout)
            del g
        else:
            # each microbatch's gradient added into the value-domain
            # accumulator leaf by leaf, each tree gradient dropped once
            # added: no packed image, no second accumulator
            if acc:
                grads = acc[0].zero_()
            else:
                grads = torch.zeros((layout.total_values,),
                                    dtype=torch_dtype(cfg.opt_moment_dtype),
                                    device=state.arena.device)
                acc.append(grads)
            loss_sum = 0.0
            for bx in _microbatches(batch, mb):
                l, g, _ = _grad_leaves(ops, cfg, params, bx)
                accumulate_values(grads, g, layout)
                loss_sum = loss_sum + l
            loss = loss_sum / mb
            grads.div_(mb)        # in the accumulator's dtype, as the tree
            del params
        arena, opt_state = arena_apply(optimizer, grads, state.opt_state,
                                       state.arena, layout)
        return ArenaTrainState(arena, opt_state, state.step + 1,
                               state.layout), loss

    train_step.release = acc.clear
    train_step.plan = plan
    return train_step
