"""Plain PyTorch version of the masked_restore kernel."""
import torch


def masked_restore_ref(dst: torch.Tensor, src: torch.Tensor,
                       mask: torch.Tensor,
                       block_rows: int = 1) -> torch.Tensor:
    """Rows of block b (``block_rows`` each, the last block ragged) from
    ``src`` where mask[b], else from ``dst``, over (R, W)."""
    row_mask = torch.repeat_interleave(mask, block_rows)[:dst.shape[0]]
    return torch.where(row_mask[:, None], src, dst)
