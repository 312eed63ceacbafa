"""Plain PyTorch versions of the block_dist kernel, per leaf and over a
whole tree."""
import torch


def block_dist_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b: (n_blocks, E) -> (n_blocks,) f32 squared L2 distances."""
    d = a.to(torch.float32) - b.to(torch.float32)
    return torch.sum(d * d, dim=1)


def block_dist_tree_ref(a_leaves: list, b_leaves: list,
                        partition) -> torch.Tensor:
    """The grouped kernel's plain version: :func:`block_dist_ref` on each
    leaf's zero-padded f32 block view, accumulated by block offset."""
    from repro_torch.core.blocks import block_scores
    return block_scores(a_leaves, b_leaves, partition,
                        lambda va, vb, leaf: block_dist_ref(va, vb))
