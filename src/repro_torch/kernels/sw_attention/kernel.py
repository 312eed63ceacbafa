"""CUDA kernel: banded causal GQA attention (sliding-window flash).

Replaces ``repro/kernels/sw_attention/kernel.py::sw_attention_pallas``.
The source, with its design note, is ``repro_torch/csrc/sw_attention.cu``.
The instance follows the dtype: bf16 (the served dtype) runs on the tensor
cores, one CTA per (bh, g, 128 query rows) walking the 64-key tiles its
band reaches, tiles loaded by TMA, Q K^T and the split P V by wgmma; f32
runs the SIMT instance (f32 FMA, 64 query rows per CTA).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (64, 128)
MAX_GRID_YZ = 65535


def sw_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      window: int) -> torch.Tensor:
    """q: (BH, G, S, Dh); k, v: (BH, S, Dh); contiguous CUDA tensors of one
    dtype, float32 or bfloat16 (bf16: each 16-byte aligned, as TMA reads
    them); Dh 64 or 128; window >= 1 (S: causal). Returns (BH, G, S, Dh)
    f32."""
    if q.device.type != "cuda" or k.device != q.device \
            or v.device != q.device:
        raise ValueError(f"sw_attention_cuda needs q, k, v on one CUDA "
                         f"device, got {q.device}, {k.device}, {v.device}")
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"sw_attention_cuda takes float32 or bfloat16 of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 3:
        raise ValueError("need q (BH, G, S, Dh) and k, v (BH, S, Dh)")
    BH, G, S, Dh = q.shape
    if k.shape != (BH, S, Dh) or v.shape != k.shape:
        raise ValueError(f"shapes disagree: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if Dh not in HEAD_DIMS:
        raise ValueError(f"head dim {Dh} is not one of {HEAD_DIMS}")
    if BH > MAX_GRID_YZ or G > MAX_GRID_YZ:
        raise ValueError(f"BH {BH} or G {G} exceeds {MAX_GRID_YZ}")
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("sw_attention_cuda needs contiguous inputs")
    if q.dtype == torch.bfloat16 \
            and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("the bf16 instance needs q, k and v 16-byte "
                         "aligned (TMA)")
    out = torch.empty((BH, G, S, Dh), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out
    _build.launch("sw_attention", _build.library().sw_attention, q.device,
                  q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  BH, G, S, Dh, min(int(window), S),
                  int(q.dtype == torch.bfloat16), 1.0 / math.sqrt(Dh))
    return out
