"""Carry parameter trees and coded parity between the JAX package and the
port.

``from_numpy_tree`` takes a JAX params tree after
``jax.tree_util.tree_map(np.asarray, p)`` and returns the port's tree of
tensors on ``device``; ``to_numpy_tree`` goes back. Keys, structure and
dtypes are kept; bfloat16 and the fp8 family (numpy ``ml_dtypes``) travel
as their raw bits. Given ``slices`` (``sharding.partition.model_slices``
of the tree) it places only this rank's model slice of each leaf (its
ranges concatenated, as ``take_model_slices`` cuts them): from
memory-mapped arrays no rank reads, or holds, the whole model. A serving
state's ``partition.state_slices`` cut it the same way (each leaf's data
shard, then its heads), so a rank's cache or SSM state can be held
against its slice of a whole one (the reference's, from numpy), and
``to_numpy_tree`` brings a rank's slice back.

``load_parity_rows`` hands a codec parity encoded elsewhere (the
reference's ``np.asarray(codec.parity)``: ``(n_groups, frame_elems)`` XOR
blocks or ``(n_groups, m, frame_elems)`` RS rows, int32) to a port codec of
the same striping, so both packages can scrub or decode one coded
snapshot; ``parity_rows_to_numpy`` goes back.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.utils.tree import tree_map

PyTree = Any


# numpy (ml_dtypes) dtypes that torch names alike and numpy cannot convert
_BIT_DTYPES = ("bfloat16", "float8_e4m3fn", "float8_e5m2", "float8_e4m3fnuz",
               "float8_e5m2fnuz", "float8_e8m0fnu")
_BITS = {1: (np.int8, torch.int8), 2: (np.int16, torch.int16)}


def _to_tensor(x, device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name in _BIT_DTYPES:
        np_bits, t_bits = _BITS[a.dtype.itemsize]
        bits = torch.from_numpy(np.array(a, copy=True).view(np_bits))
        return bits.view(getattr(torch, a.dtype.name)).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    name = str(t.dtype).removeprefix("torch.")
    if name in _BIT_DTYPES:
        import ml_dtypes
        np_bits, t_bits = _BITS[t.dtype.itemsize]
        return t.view(t_bits).numpy().view(getattr(ml_dtypes, name))
    return t.numpy().copy()


def from_numpy_tree(tree: PyTree, device, slices: PyTree = None
                    ) -> PyTree:
    dev = torch.device(device)
    if slices is None:
        return tree_map(lambda x: _to_tensor(x, dev), tree)

    return tree_map(lambda x, s: _to_tensor(_cut(x, s), dev), tree, slices)


def _cut(x, s):
    """``x`` (an array) cut to ``s``: a ``ModelSlice``'s ranges of its dim
    (concatenated), or each cut of a ``StateSlice`` in turn."""
    a = np.asarray(x)
    if not s:
        return a
    if isinstance(s[0], tuple):     # a StateSlice: its cuts in turn
        for cut in s:
            a = _cut(a, cut)
        return a
    dim = s[0]
    parts = [a[(slice(None),) * dim + (slice(lo, hi),)]
             for lo, hi in s.ranges]
    return parts[0] if len(parts) == 1 else np.concatenate(parts, axis=dim)


def to_numpy_tree(tree: PyTree) -> PyTree:
    return tree_map(_to_numpy, tree)


def load_parity_rows(codec, rows, step: int,
                     device: DeviceLike = None) -> None:
    """Adopt ``rows`` as ``codec``'s parity, encoded at ``step``, on
    ``device`` (``cuda`` when None; raises where no CUDA device is
    present)."""
    device = resolve_device(device)
    a = np.ascontiguousarray(np.asarray(rows), np.int32)
    want = (codec.n_groups,) + ((codec.n_parity,) if codec.needs_arena_encode
                                else ()) + (codec.layout.frame_elems,)
    if a.shape != want:
        raise ValueError(f"parity rows of shape {a.shape}, the codec's "
                         f"striping has {want}")
    codec.parity = torch.from_numpy(a.copy()).to(device)
    codec.encoded_step = int(step)


def parity_rows_to_numpy(codec) -> np.ndarray:
    """The codec's stored parity as int32 numpy."""
    if codec.parity is None:
        raise ValueError("the codec holds no parity")
    return codec.parity.detach().cpu().numpy().copy()
