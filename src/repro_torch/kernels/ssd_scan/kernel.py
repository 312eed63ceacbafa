"""CUDA kernel: Mamba2 SSD intra-chunk dual form [arXiv:2405.21060].

Replaces ``repro/kernels/ssd_scan/kernel.py::ssd_intra_pallas``. The
source, with its design note, is ``repro_torch/csrc/ssd_intra.cu``: one
CTA per (batch, chunk, head) holds the chunk's C, B (transposed) and x in
shared memory and computes the causal half of ``M`` a block of rows at a
time, so the (Q, Q) matrix never lies whole in memory.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

MAX_CHUNK = 128                    # kMaxQ in csrc/ssd_intra.cu
SMEM_LIMIT = 232448                # bytes of shared memory one CTA can use


def ssd_intra_smem_bytes(Q: int, N: int, P: int) -> int:
    """Dynamic shared memory the kernel needs (mirrors csrc/ssd_intra.cu)."""
    row_block = 16
    return 4 * (Q * N + N * (Q + 1) + Q * P + 3 * Q + row_block * Q)


def ssd_intra_cuda(la, dt, x, Bm, Cm):
    """la, dt: (B, nc, Q, H); x: (B, nc, Q, H, P); Bm, Cm: (B, nc, Q, N);
    contiguous f32 CUDA tensors on one device, Q <= 128.
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
