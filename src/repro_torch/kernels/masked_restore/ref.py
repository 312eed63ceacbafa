"""Plain PyTorch versions of the masked_restore kernel, per leaf and over a
whole tree."""
import torch

from repro_torch.core.blocks import split_global_mask
from repro_torch.utils.tree import tree_flatten, tree_leaves, tree_unflatten


def masked_restore_ref(dst: torch.Tensor, src: torch.Tensor,
                       mask: torch.Tensor,
                       block_rows: int = 1) -> torch.Tensor:
    """Rows of block b (``block_rows`` each, the last block ragged) from
    ``src`` where mask[b], else from ``dst``, over (R, W)."""
    row_mask = torch.repeat_interleave(mask, block_rows)[:dst.shape[0]]
    return torch.where(row_mask[:, None], src, dst)


def tree_masked_restore_ref(dst, src, global_mask: torch.Tensor, partition):
    """The grouped kernel's plain version: :func:`masked_restore_ref` on
    each leaf's raw (R, W) rows, ``src`` cast to dst's dtype. Returns a new
    tree."""
    dst_flat, treedef = tree_flatten(dst)
    masks = split_global_mask(global_mask.to(torch.bool), partition)
    out = []
    for d, s, m, leaf in zip(dst_flat, tree_leaves(src), masks,
                             partition.leaves):
        shape2d = (leaf.rows, leaf.row_width)
        r = masked_restore_ref(d.reshape(shape2d),
                               s.to(d.dtype).reshape(shape2d), m,
                               partition.block_rows)
        out.append(r.reshape(leaf.shape))
    return tree_unflatten(treedef, out)
