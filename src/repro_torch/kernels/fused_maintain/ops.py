"""Tree-level in-place partial save backed by the scatter_save kernel.

``tree_scatter_save`` is the fabric-less save of ``FTController``
(``inplace_save=True``): only the selected blocks of each touched leaf are
copied, in place into the running checkpoint's tensors. Unlike the
reference it needs no padding of k to a power of two (that bounded jit
recompiles), but it keeps the reference's ``moved`` accounting: the
selected blocks' bytes, counted once.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.blocks import BlockPartition
from repro_torch.kernels.fused_maintain.kernel import scatter_save_cuda
from repro_torch.kernels.fused_maintain.ref import scatter_save_ref
from repro_torch.utils.tree import tree_flatten, tree_leaves, tree_unflatten

PyTree = Any


def scatter_save(dst: torch.Tensor, src: torch.Tensor, rows: torch.Tensor,
                 block_rows: int) -> torch.Tensor:
    """In-place block scatter over a (R, W) row matrix: the plain version
    for CPU tensors, the CUDA kernel otherwise."""
    if dst.device.type == "cpu":
        return scatter_save_ref(dst, src, rows, block_rows)
    return scatter_save_cuda(dst, src, rows, block_rows)


def tree_scatter_save(dst: PyTree, src: PyTree, global_idx,
                      partition: BlockPartition) -> tuple[PyTree, int]:
    """Overwrite the selected blocks of ``dst`` from ``src`` in place.

    ``global_idx``: host-side selected global block ids. Leaves with no
    selected block are not touched; colocated leaves each copy their own
    payload for the shared ids. Returns ``(dst, bytes_moved)``.
    """
    idx = np.unique(np.asarray(global_idx, np.int64))
    if idx.size and (idx[0] < 0 or idx[-1] >= partition.total_blocks):
        raise IndexError(f"block ids must lie in [0, "
                         f"{partition.total_blocks})")
    dst_flat, treedef = tree_flatten(dst)
    src_flat = tree_leaves(src)
    br = partition.block_rows
    moved = 0
    for d, s, leaf in zip(dst_flat, src_flat, partition.leaves):
        lo = np.searchsorted(idx, leaf.offset)
        hi = np.searchsorted(idx, leaf.offset + leaf.n_blocks)
        sel = (idx[lo:hi] - leaf.offset).astype(np.int32)
        if sel.size == 0:
            continue
        if not d.is_contiguous():
            raise ValueError(f"checkpoint leaf {leaf.name} is not "
                             f"contiguous; an in-place save needs it so")
        rows, width = leaf.rows, leaf.row_width
        d2 = d.view(rows, width)
        s2 = s.to(d.dtype).reshape(rows, width).contiguous()
        scatter_save(d2, s2, torch.from_numpy(sel).to(d.device), br)
        rows_per = np.minimum((sel + 1) * br, rows) - sel * br
        moved += int(rows_per.clip(min=0).sum()) * leaf.row_width \
            * d.element_size()
    return tree_unflatten(treedef, dst_flat), moved
