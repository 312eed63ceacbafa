"""Train state containers of the LM trainer.

The port of ``repro.training.train_state``. Two live representations:

- :class:`TrainState`: the PyTree form (params as a tree of leaf-shaped
  tensors), behind ``TrainLoopConfig(arena_state=False)`` and for models
  the arena cannot hold.
- :class:`ArenaTrainState`: the arena-native form. The canonical live
  parameters are ONE contiguous int32 word buffer laid out by an
  :class:`~repro_torch.core.arena.ArenaLayout`, and the optimizer moments
  are flat f32 mirrors of its value domain. The fault-tolerance hot path
  (the fabric's maintenance sweep and the controller's partial save)
  reads ``state.arena`` directly, and the train step updates it in place.
  :attr:`ArenaTrainState.params` decodes a lazily cached tree view for
  analysis (never the hot loop).

``step`` is a host int here (the reference's is a device scalar): the
loop reads it every step, and a device scalar would wait for the card.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.optim.optimizers import OptState

PyTree = Any


@dataclasses.dataclass
class TrainState:
    params: PyTree
    opt_state: OptState
    step: int

    @classmethod
    def create(cls, params: PyTree, optimizer) -> "TrainState":
        return cls(params=params, opt_state=optimizer.init(params), step=0)


@dataclasses.dataclass
class ArenaTrainState:
    """Arena-resident training state: ``arena`` is the canonical live
    parameter representation (``layout.total_words`` int32 words);
    ``opt_state``'s moment buffers are ``(layout.total_values,)`` f32
    mirrors of it. On a mesh both are the rank's span (``shard_words``),
    and None on a rank outside the (shrunk) mesh. ``layout`` must be the instance the controller's fabric
    built (layouts compare by identity)."""
    arena: torch.Tensor
    opt_state: OptState
    step: int
    layout: Any = None

    @classmethod
    def create(cls, arena: torch.Tensor, optimizer,
               layout) -> "ArenaTrainState":
        # the moments live in the value domain (total_values ==
        # total_words for all-f32 layouts; more for sub-word dtypes); on a
        # mesh the arena is the rank's span of an all-f32 layout, and so
        # are they. init reads only the shape
        n = (layout.total_values if arena.numel() == layout.total_words
             else arena.numel())
        seed = torch.zeros((n,), dtype=torch.float32, device=arena.device)
        return cls(arena=arena, opt_state=optimizer.init(seed), step=0,
                   layout=layout)

    @property
    def params(self) -> PyTree:
        """Lazily cached tree view of the arena (decoded on first access;
        the hot loop never calls this). The cache is keyed on the arena
        tensor and its version counter, so both a new arena and an
        in-place update of this one decode afresh rather than serve stale
        values."""
        if self.layout is None:
            raise ValueError("ArenaTrainState needs its layout to decode "
                             "params")
        cached = getattr(self, "_tree_view", None)
        if cached is None or cached[0] is not self.arena \
                or cached[1] != self.arena._version:
            from repro_torch.core.arena import unpack_arena
            cached = (self.arena, self.arena._version,
                      unpack_arena(self.arena, self.layout))
            self._tree_view = cached
        return cached[2]
