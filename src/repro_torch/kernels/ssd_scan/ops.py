"""The full SSD scan with the intra-chunk part on the kernel.

``ssd_chunked_kernel`` has the contract of the reference's
``repro.models.ssm.ssd_chunked`` (the pure-jnp oracle) and of
``repro.kernels.ssd_scan.ops.ssd_chunked_kernel``: :func:`ssd_intra` for
the quadratic part, then the O(nc) inter-chunk recurrence (a loop over the
chunks) and the rank-1 ``y_inter`` correction in plain torch. The port's
``models.ssm`` runs its SSD scan through it, so on the card prefill
launches the kernel once per layer.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ssd_scan.kernel import ssd_intra_cuda
from repro_torch.kernels.ssd_scan.ref import ssd_intra_ref


def ssd_intra(la, dt, x, Bm, Cm):
    """Intra-chunk SSD: the plain version for CPU tensors (and meta ones,
    the dry run's: no kernel runs there), the CUDA kernel otherwise."""
    if la.device.type in ("cpu", "meta"):
        return ssd_intra_ref(la, dt, x, Bm, Cm)
    return ssd_intra_cuda(*(t.to(torch.float32).contiguous()
                            for t in (la, dt, x, Bm, Cm)))


def ssd_chunked_kernel(x, dt, A, Bm, Cm, chunk: int, h0=None):
    """Full SSD scan.

    x: (B,S,H,P); dt: (B,S,H) (post-softplus); A: (H,) negative;
    Bm, Cm: (B,S,N); h0: (B,H,P,N) or None.
    Returns (y (B,S,H,P), h_final (B,H,P,N)), f32.
    """
    return _ssd_chunked(ssd_intra, x, dt, A, Bm, Cm, chunk, h0)


def ssd_chunked_plain(x, dt, A, Bm, Cm, chunk: int, h0=None):
    """:func:`ssd_chunked_kernel` with the plain intra-chunk part on every
    device: the reference's jnp ``ssd_chunked``, differentiable, so the
    trainer runs its scan through it."""
    return _ssd_chunked(ssd_intra_ref, x, dt, A, Bm, Cm, chunk, h0)


def _ssd_chunked(intra, x, dt, A, Bm, Cm, chunk: int, h0=None):
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    nc = S // Q
    if nc * Q != S:
        raise ValueError(f"seq {S} must be divisible by chunk {Q}")

    la = (dt * A).reshape(Bsz, nc, Q, H)
    xc = x.reshape(Bsz, nc, Q, H, P)
    dtc = dt.reshape(Bsz, nc, Q, H)
    Bc = Bm.reshape(Bsz, nc, Q, N)
    Cc = Cm.reshape(Bsz, nc, Q, N)

    y_intra, chunk_state = intra(la, dtc, xc, Bc, Cc)
    chunk_state = chunk_state.transpose(-1, -2)              # (B,nc,H,P,N)

    cum = torch.cumsum(la, dim=2)
    seg = torch.exp(cum[:, :, -1])                           # (B,nc,H)
    h = h0 if h0 is not None else torch.zeros(
        (Bsz, H, P, N), dtype=torch.float32, device=x.device)
    h_prev = []
    for c in range(nc):
        h_prev.append(h)                                     # state BEFORE chunk
        h = h * seg[:, c, :, None, None] + chunk_state[:, c]
    h_prev = torch.stack(h_prev, dim=1)                      # (B,nc,H,P,N)

    y_inter = torch.einsum("bcin,bchpn->bcihp", Cc, h_prev) \
        * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(Bsz, S, H, P)
    return y, h
