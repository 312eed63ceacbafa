"""CUDA kernel: Mamba2 SSD intra-chunk dual form [arXiv:2405.21060].

Replaces ``repro/kernels/ssd_scan/kernel.py::ssd_intra_pallas``. The
source, with its design note, is ``repro_torch/csrc/ssd_intra.cu``: one
CTA per (batch, chunk) computes G = C B^T once, keeps it in shared memory
and loops over the heads, each head's M, y = M x and state = B^T (x w) on
the tensor cores as three TF32 products per product (f32-grade sums).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

MAX_CHUNK = 128                    # kMaxQ in csrc/ssd_intra.cu
SMEM_LIMIT = 232448                # bytes of shared memory one CTA can use


def _round_up(v: int, m: int) -> int:
    return (v + m - 1) // m * m


def ssd_intra_smem_bytes(Q: int, N: int, P: int) -> int:
    """Dynamic shared memory the kernel needs (mirrors ``make_dims`` and
    ``smem_floats`` in csrc/ssd_intra.cu): B, G, the region C shares with
    two x buffers (one where two do not fit), and six per-head vectors; Q
    and N padded to 16, P to 64, row strides to the bank pattern."""
    Qp, Np, Pp = _round_up(Q, 16), _round_up(N, 16), _round_up(P, 64)
    ldb, ldc = _round_up(Np, 32) + 8, _round_up(Np, 32) + 4
    ldg, ldx = _round_up(Qp, 32) + 4, _round_up(Pp, 32) + 8

    def total(xbufs):
        region = max(Qp * ldc, xbufs * Qp * ldx)
        return 4 * (Qp * ldb + Qp * ldg + region + 6 * Qp)
    return total(2) if total(2) <= SMEM_LIMIT else total(1)


def ssd_intra_cuda(la, dt, x, Bm, Cm):
    """la, dt: (B, nc, Q, H); x: (B, nc, Q, H, P); Bm, Cm: (B, nc, Q, N);
    contiguous f32 CUDA tensors on one device, Q <= 128, and (Q, N, P)
    within the shared memory of one CTA (``ssd_intra_smem_bytes``): at
    Q = N = 128, P <= 128, with x single-buffered above P = 64.
    Returns (y (B, nc, Q, H, P), state (B, nc, H, N, P)) f32."""
    ins = (la, dt, x, Bm, Cm)
    if la.device.type != "cuda" or any(t.device != la.device for t in ins):
        raise ValueError(f"ssd_intra_cuda needs five tensors on one CUDA "
                         f"device, got {[str(t.device) for t in ins]}")
    if any(t.dtype != torch.float32 for t in ins):
        raise TypeError(f"ssd_intra_cuda takes float32, got "
                        f"{[t.dtype for t in ins]}")
    if la.dim() != 4 or x.dim() != 5 or Bm.dim() != 4:
        raise ValueError("need la, dt (B, nc, Q, H), x (B, nc, Q, H, P) and "
                         "Bm, Cm (B, nc, Q, N)")
    B, nc, Q, H = la.shape
    P, N = x.shape[-1], Bm.shape[-1]
    if dt.shape != la.shape or x.shape != (B, nc, Q, H, P) \
            or Bm.shape != (B, nc, Q, N) or Cm.shape != Bm.shape:
        raise ValueError(f"shapes disagree: la {tuple(la.shape)}, dt "
                         f"{tuple(dt.shape)}, x {tuple(x.shape)}, Bm "
                         f"{tuple(Bm.shape)}, Cm {tuple(Cm.shape)}")
    if not all(t.is_contiguous() for t in ins):
        raise ValueError("ssd_intra_cuda needs contiguous inputs")
    if Q > MAX_CHUNK:
        raise ValueError(f"chunk of {Q} rows exceeds the kernel's "
                         f"{MAX_CHUNK}")
    smem = ssd_intra_smem_bytes(Q, N, P)
    if smem > SMEM_LIMIT:
        raise ValueError(f"(Q, N, P) = {(Q, N, P)} needs {smem} bytes of "
                         f"shared memory, more than {SMEM_LIMIT}")
    y = torch.empty((B, nc, Q, H, P), dtype=torch.float32, device=la.device)
    state = torch.empty((B, nc, H, N, P), dtype=torch.float32,
                        device=la.device)
    if y.numel() == 0 and state.numel() == 0:
        return y, state
    _build.launch("ssd_intra", _build.library().ssd_intra, la.device,
                  la.data_ptr(), dt.data_ptr(), x.data_ptr(), Bm.data_ptr(),
                  Cm.data_ptr(), y.data_ptr(), state.data_ptr(), B, nc, Q, H,
                  P, N)
    return y, state
