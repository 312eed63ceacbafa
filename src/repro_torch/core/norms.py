"""Pluggable block norms for priority scoring (paper §4.2 + Appendix C).

The port of ``repro.core.norms``. A norm function has signature
``(a_view, b_view, leaf) -> (n_blocks,)`` where the views are
``(n_blocks, block_rows * row_width)`` float32 tensors produced by
:func:`repro_torch.core.blocks.leaf_block_view`.

- ``l2``          -- squared L2 distance per block (default; what Theorems
                     4.1/4.2 measure). On a CUDA tensor it is the
                     ``block_dist`` kernel, the drop-in the JAX package
                     documents for it; on a CPU tensor, the kernel's plain
                     version. It carries a whole-tree form (``.tree``,
                     ``tree_block_dist``) that ``block_scores`` calls in
                     place of its per-leaf loop: one grouped launch a tree.
- ``l1``, ``linf``-- absolute-difference sum and maximum.
- ``scaled_tv``   -- scaled total variation for distribution-valued rows
                     (Appendix C, LDA): per-row TV = 1/2 sum |p - q| scaled
                     by a per-row weight (document length), summed per
                     block. Uniform weights when none is registered.

Norms are registered by name so ``CheckpointPolicy.norm`` stays a plain
string. Per-leaf auxiliary data (e.g. document lengths) is passed as
``aux``, keyed by leaf name.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F

from repro_torch.core.blocks import LeafMeta
from repro_torch.kernels.block_dist.ops import block_dist, tree_block_dist

NormFn = Callable[[torch.Tensor, torch.Tensor, LeafMeta], torch.Tensor]

_REGISTRY: Dict[str, Callable[..., NormFn]] = {}


def register_norm(name: str):
    def deco(factory):
        _REGISTRY[name] = factory
        return factory
    return deco


def get_norm(name: str, aux=None, block_rows: int = 128) -> NormFn:
    if name not in _REGISTRY:
        raise KeyError(f"unknown norm {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name](aux=aux, block_rows=block_rows)


@register_norm("l2")
def _sq_l2_factory(aux=None, block_rows: int = 128) -> NormFn:
    def sq_l2(a, b, leaf):
        return block_dist(a, b)
    sq_l2.tree = tree_block_dist
    return sq_l2


@register_norm("l1")
def _l1_factory(aux=None, block_rows: int = 128) -> NormFn:
    def l1(a, b, leaf):
        return torch.sum(torch.abs(a - b), dim=-1)
    return l1


@register_norm("linf")
def _linf_factory(aux=None, block_rows: int = 128) -> NormFn:
    def linf(a, b, leaf):
        return torch.amax(torch.abs(a - b), dim=-1)
    return linf


@register_norm("scaled_tv")
def _scaled_tv_factory(aux=None, block_rows: int = 128) -> NormFn:
    """aux: dict leaf-name -> (rows,) weight vector (document lengths)."""
    aux = aux or {}

    def scaled_tv(a, b, leaf):
        n_blocks = a.shape[0]
        width = leaf.row_width
        ar = a.reshape(n_blocks, -1, width)
        br = b.reshape(n_blocks, -1, width)
        tv = 0.5 * torch.sum(torch.abs(ar - br), dim=-1)  # (n_blocks, rows/block)
        w = aux.get(leaf.name)
        if w is not None:
            w = torch.as_tensor(w, dtype=torch.float32, device=a.device)
            pad = n_blocks * tv.shape[1] - leaf.rows
            if pad:
                w = F.pad(w, (0, pad))
            tv = tv * w.reshape(n_blocks, tv.shape[1])
        return torch.sum(tv, dim=-1)
    return scaled_tv
