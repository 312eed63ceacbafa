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
    # the mask goes in before the exp: above the diagonal ``decay`` is
    # positive and its exp overflows to inf over a long chunk, and
    # ``where(causal, exp(decay), 0)`` would then carry inf * 0 = nan into
    # the gradient; masked to -inf the exp is 0 with a zero gradient, and
    # the forward values are the same
    M = torch.exp(torch.where(causal[None, None, :, :, None], decay,
                              torch.full((), -torch.inf, device=la.device))) \
        * scores[..., None] * dt[:, :, None, :, :]
    y = torch.einsum("bcijh,bcjhp->bcihp", M, x)
    w = torch.exp(cum[:, :, -1:, :] - cum) * dt                # (B,nc,Q,H)
    state = torch.einsum("bcjn,bcjhp->bchnp", Bm, x * w[..., None])
    return y, state
