"""Plain versions of the GF(256) multiply-accumulate.

- :func:`gf256_mac_ref`: the torch form of the reference's oracle
  (``repro/kernels/gf256_mac/ref.py:40``) on the dense ``(n_groups, g, E)``
  frames: every int32 word carries four GF(256) symbols, each byte is
  scaled by log/antilog gathers and folded into the accumulator with XOR.
- :func:`gf256_mac_np`: its numpy mirror, for host-side tests.
- :func:`gf256_mac_plan_ref`: the plain version of the CUDA kernel on a
  :class:`~repro_torch.kernels.gf256_mac.ops.GFPlan` (rows of m outputs,
  terms read in place from two sources); ``ops.py`` runs it on CPU
  tensors only.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.gf256_mac.tables import GF_EXP, GF_LOG

_TABLES: dict = {}


def _tables(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    key = str(device)
    if key not in _TABLES:
        _TABLES[key] = (torch.from_numpy(GF_EXP[:255].copy()).to(device),
                        torch.from_numpy(GF_LOG.copy()).to(device))
    return _TABLES[key]


def gf_scale_words(words: torch.Tensor, coeff: torch.Tensor) -> torch.Tensor:
    """Each byte of int32 ``words`` (..., E) times the GF(256) byte
    ``coeff`` (broadcast against ``words[..., 0]``): log/antilog gathers
    over the words' bytes, zero bytes and zero coefficients giving 0."""
    exp, log = _tables(words.device)
    b = words.contiguous().view(torch.uint8).to(torch.int64)
    c = coeff.to(device=words.device, dtype=torch.int64)[..., None]
    prod = exp[(log[b] + log[c]) % 255]
    prod = torch.where((b == 0) | (c == 0), 0, prod)
    return prod.to(torch.uint8).view(torch.int32)


def gf256_mac_ref(frames: torch.Tensor, base: torch.Tensor,
                  coeff: torch.Tensor) -> torch.Tensor:
    """``base ^ XOR_i gf_mul(coeff[:, i], frames[:, i, :])`` per group.

    frames: (n_groups, g, E) int32; base: (n_groups, E) int32; coeff:
    (n_groups, g) GF(256) bytes (0 drops a member, 1 is plain XOR)."""
    scaled = gf_scale_words(frames.to(torch.int32), coeff)
    out = base.to(torch.int32).clone()
    for i in range(scaled.shape[1]):
        out ^= scaled[:, i]
    return out


def gf256_mac_np(frames: np.ndarray, base: np.ndarray,
                 coeff: np.ndarray) -> np.ndarray:
    """Numpy mirror of :func:`gf256_mac_ref`, per byte plane."""
    frames = np.asarray(frames, np.int64) & 0xFFFFFFFF
    coeff = np.asarray(coeff, np.int64)
    acc = np.asarray(base, np.int64) & 0xFFFFFFFF
    for plane in range(4):
        b = (frames >> (8 * plane)) & 0xFF
        prod = GF_EXP[(GF_LOG[b] + GF_LOG[coeff[..., None]]) % 255]
        prod = np.where((b == 0) | (coeff[..., None] == 0), 0, prod)
        acc = acc ^ (np.bitwise_xor.reduce(prod, axis=1) << (8 * plane))
    return (acc & 0xFFFFFFFF).astype(np.uint32).view(np.int32)


def gf256_mac_plan_ref(out: torch.Tensor, src: torch.Tensor, src2, base,
                       t: dict, row0: int, n_rows: int,
                       out_shift: int) -> torch.Tensor:
    """Plain version of ``gf256_mac_cuda``: the same inputs, rows
    ``[row0, row0 + n_rows)`` written into ``out`` (shifted down by
    ``out_shift`` words). Returns ``out``."""
    m, ostr, bstr = int(t["m"]), int(t["out_stride"]), int(t["base_stride"])
    row_out = t["row_out"].tolist()
    row_len = t["row_len"].tolist()
    row_base = t["row_base"].tolist()
    term_ptr = t["term_ptr"].tolist()
    dst, soff, n = (t["term_dst"].tolist(), t["term_src"].tolist(),
                    t["term_len"].tolist())
    sel = t["term_sel"].tolist()
    coef = t["term_coef"].view(-1, m)
    for r in range(row0, row0 + n_rows):
        o, length, b = row_out[r] - out_shift, row_len[r], row_base[r]
        rows = [out[o + q * ostr:o + q * ostr + length] for q in range(m)]
        for q, row in enumerate(rows):
            if b >= 0:
                row.copy_(base[b + q * bstr:b + q * bstr + length])
            else:
                row.zero_()
        for k in range(term_ptr[r], term_ptr[r + 1]):
            words = (src2 if sel[k] else src)[soff[k]:soff[k] + n[k]]
            scaled = gf_scale_words(words[None].expand(m, -1), coef[k])
            for q, row in enumerate(rows):
                row[dst[k]:dst[k] + n[k]] ^= scaled[q]
    return out
