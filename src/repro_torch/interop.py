"""Carry parameter trees between the JAX package and the port.

``from_numpy_tree`` takes a JAX params tree after
``jax.tree_util.tree_map(np.asarray, p)`` and returns the port's tree of
tensors on ``device``; ``to_numpy_tree`` goes back. Keys, structure and
dtypes are kept; bfloat16 (numpy ``ml_dtypes``) travels as its raw bits.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.utils.tree import tree_map

PyTree = Any


def _to_tensor(x, device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy().copy()


def from_numpy_tree(tree: PyTree, device) -> PyTree:
    return tree_map(lambda x: _to_tensor(x, torch.device(device)), tree)


def to_numpy_tree(tree: PyTree) -> PyTree:
    return tree_map(_to_numpy, tree)
