"""Perturbation generators (paper §5.2 experiment types).

The port of ``repro.core.perturb``:

- ``random``      -- isotropic Gaussian of a target norm (Fig. 3a, 5a).
- ``adversarial`` -- away from the optimum: δ = s · (x − x*)/||x − x*||.
- ``reset``       -- reset a uniformly-random fraction of parameter blocks
                     to their initial values (Fig. 6).

Each maps a parameter tree to a perturbed tree and also returns ||δ||.
Random draws come from a ``torch.Generator`` and are made on its device.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.blocks import BlockPartition, select_blocks, tree_sq_norm
from repro_torch.core.recovery import sample_failure_mask
from repro_torch.utils.tree import tree_leaves, tree_map

PyTree = Any


def _tree_random_like(gen: torch.Generator, tree: PyTree) -> PyTree:
    return tree_map(
        lambda x: torch.randn(tuple(x.shape), generator=gen,
                              dtype=torch.float32, device=gen.device)
        .to(device=x.device, dtype=x.dtype), tree)


def _tree_scale(tree: PyTree, s) -> PyTree:
    return tree_map(lambda x: (x.to(torch.float32) * s).to(x.dtype), tree)


def _tree_add(a: PyTree, b: PyTree) -> PyTree:
    return tree_map(lambda x, y: x + y.to(x.dtype), a, b)


def _tree_sub(a: PyTree, b: PyTree) -> PyTree:
    return tree_map(lambda x, y: x - y.to(x.dtype), a, b)


def random_perturbation(gen: torch.Generator, params: PyTree, norm: float,
                        ) -> tuple[PyTree, torch.Tensor]:
    """Gaussian direction scaled to ``norm``. Returns (perturbed, ||δ||)."""
    noise = _tree_random_like(gen, params)
    nsq = tree_sq_norm(noise, _tree_scale(noise, 0.0))
    scale = norm / torch.sqrt(nsq + 1e-30)
    delta = _tree_scale(noise, scale)
    return _tree_add(params, delta), torch.tensor(norm, dtype=torch.float32)


def adversarial_perturbation(params: PyTree, x_star: PyTree, norm: float,
                             ) -> tuple[PyTree, torch.Tensor]:
    """δ points away from the optimum: δ = s·(x − x*)/||x − x*|| (Fig. 5b)."""
    direction = _tree_sub(params, x_star)
    dsq = tree_sq_norm(params, x_star)
    scale = norm / torch.sqrt(dsq + 1e-30)
    delta = _tree_scale(direction, scale)
    return _tree_add(params, delta), torch.tensor(norm, dtype=torch.float32)


def reset_perturbation(gen: torch.Generator, params: PyTree, x0: PyTree,
                       fraction: float, partition: BlockPartition,
                       ) -> tuple[PyTree, torch.Tensor]:
    """Reset a random fraction of parameter blocks to initial values (Fig. 6).

    ``gen`` is a CPU generator. Returns (perturbed, ||δ||).
    """
    device = tree_leaves(params)[0].device
    mask = sample_failure_mask(gen, partition, fraction, device)
    perturbed = select_blocks(params, x0, mask, partition)
    dn = torch.sqrt(tree_sq_norm(perturbed, params))
    return perturbed, dn
