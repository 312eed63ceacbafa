"""Carry parameter trees between the JAX package and the port.

``from_numpy_tree`` takes a JAX params tree after
``jax.tree_util.tree_map(np.asarray, p)`` and returns the port's tree of
tensors on ``device``; ``to_numpy_tree`` goes back. Keys, structure and
dtypes are kept; bfloat16 and the fp8 family (numpy ``ml_dtypes``) travel
as their raw bits.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

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


def from_numpy_tree(tree: PyTree, device) -> PyTree:
    return tree_map(lambda x: _to_tensor(x, torch.device(device)), tree)


def to_numpy_tree(tree: PyTree) -> PyTree:
    return tree_map(_to_numpy, tree)
