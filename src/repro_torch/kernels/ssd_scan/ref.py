"""Plain PyTorch version of the ssd_intra kernel."""
import torch


def ssd_intra_ref(la, dt, x, Bm, Cm):
    """Same contract as the kernel (``ssd_intra_cuda``).

    la, dt: (B, nc, Q, H); x: (B, nc, Q, H, P); Bm, Cm: (B, nc, Q, N); f32.
    Returns (y_intra (B, nc, Q, H, P), chunk_state (B, nc, H, N, P)).
    """
    Q = la.shape[2]
    cum = torch.cumsum(la, dim=2)                              # (B,nc,Q,H)
    scores = torch.einsum("bcin,bcjn->bcij", Cm, Bm)           # (B,nc,Q,Q)
    decay = cum[:, :, :, None, :] - cum[:, :, None, :, :]      # (B,nc,Q,Q,H)
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                   device=la.device))
    M = torch.where(causal[None, None, :, :, None], torch.exp(decay),
                    torch.zeros((), device=la.device)) \
        * scores[..., None] * dt[:, :, None, :, :]
    y = torch.einsum("bcijh,bcjhp->bcihp", M, x)
    w = torch.exp(cum[:, :, -1:, :] - cum) * dt                # (B,nc,Q,H)
    state = torch.einsum("bcjn,bcjhp->bchnp", Bm, x * w[..., None])
    return y, state
