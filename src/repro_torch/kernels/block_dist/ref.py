"""Plain PyTorch version of the block_dist kernel."""
import torch


def block_dist_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b: (n_blocks, E) -> (n_blocks,) f32 squared L2 distances."""
    d = a.to(torch.float32) - b.to(torch.float32)
    return torch.sum(d * d, dim=1)
