"""Plain PyTorch version of the scatter_save kernel."""
import torch


def scatter_save_ref(dst: torch.Tensor, src: torch.Tensor,
                     rows: torch.Tensor, block_rows: int) -> torch.Tensor:
    """``dst`` (R, W) with the selected blocks' rows overwritten from
    ``src``, in place; the ragged last block is clipped to R rows and
    duplicate ids rewrite the same values. Returns ``dst``."""
    n_rows = dst.shape[0]
    rows = rows.to(device=dst.device, dtype=torch.int64)
    row_idx = (rows[:, None] * block_rows
               + torch.arange(block_rows, device=dst.device)[None, :])
    row_idx = row_idx.reshape(-1)
    row_idx = row_idx[row_idx < n_rows]
    dst[row_idx] = src[row_idx]
    return dst
