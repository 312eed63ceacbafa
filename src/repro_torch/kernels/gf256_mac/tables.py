"""GF(256) field tables and host-side linear algebra of the RS tier.

The port's own copy of ``repro.kernels.gf256_mac.tables`` (plain numpy),
in the same field: polynomial 0x11D (x^8 + x^4 + x^3 + x^2 + 1, generator
alpha = 2, the RAID-6 convention), so the two packages' parity rows
compare byte for byte.

- ``GF_EXP`` / ``GF_LOG``: the antilog and log tables the plain versions
  gather from (``GF_EXP`` doubled, so ``EXP[log a + log b]`` needs no
  reduction; ``LOG[0]`` is a sentinel every consumer masks out).
- :func:`rs_coefficients`: the Cauchy encode matrix with row 0 scaled to
  all ones. Every square submatrix of a Cauchy matrix is nonsingular, so
  any <= m erasures decode against any m surviving parity rows, and RS(k,
  1) row 0 is bit-identical to the XOR tier's parity.
- :func:`rs_decode_weights`: the Gauss-Jordan solve that turns one
  group's erasure pattern into per-source decode weights.
"""
from __future__ import annotations

import numpy as np

GF_POLY = 0x11D

GF_EXP = np.zeros((512,), np.int32)
GF_LOG = np.zeros((256,), np.int32)
_x = 1
for _i in range(255):
    GF_EXP[_i] = _x
    GF_LOG[_x] = _i
    _x <<= 1
    if _x & 0x100:
        _x ^= GF_POLY
GF_EXP[255:510] = GF_EXP[:255]
del _x, _i


def gf_mul(a, b):
    """Elementwise GF(256) product of arrays or scalars in [0, 256)."""
    a = np.asarray(a, np.int32)
    b = np.asarray(b, np.int32)
    out = GF_EXP[GF_LOG[a] + GF_LOG[b]]
    return np.where((a == 0) | (b == 0), 0, out)


def gf_inv(a):
    """Multiplicative inverse; 0 has none (raises)."""
    a = np.asarray(a, np.int32)
    if np.any(a == 0):
        raise ZeroDivisionError("gf_inv(0) is undefined")
    return GF_EXP[255 - GF_LOG[a]]


def gf_scale_words_np(words, c) -> np.ndarray:
    """Each byte of packed int32 ``words`` times the scalar byte ``c``
    (the host mirror of the kernel's multiply; syndrome localization uses
    it)."""
    words = np.asarray(words, np.int64) & 0xFFFFFFFF
    out = np.zeros_like(words)
    for plane in range(4):
        b = (words >> (8 * plane)) & 0xFF
        out |= gf_mul(b, c).astype(np.int64) << (8 * plane)
    return (out & 0xFFFFFFFF).astype(np.uint32).view(np.int32)


def gf_mat_inv(a: np.ndarray) -> np.ndarray:
    """Inverse of a square matrix over GF(256) (Gauss-Jordan). Raises
    ``np.linalg.LinAlgError`` on a singular input: with Cauchy
    coefficients that means a malformed erasure pattern."""
    a = np.array(a, np.int32, copy=True)
    n = a.shape[0]
    out = np.eye(n, dtype=np.int32)
    for col in range(n):
        piv = col + int(np.argmax(a[col:, col] != 0))
        if a[piv, col] == 0:
            raise np.linalg.LinAlgError("singular GF(256) matrix")
        if piv != col:
            a[[col, piv]] = a[[piv, col]]
            out[[col, piv]] = out[[piv, col]]
        inv = gf_inv(a[col, col])
        a[col] = gf_mul(a[col], inv)
        out[col] = gf_mul(out[col], inv)
        for r in range(n):
            if r != col and a[r, col]:
                f = a[r, col]
                a[r] ^= gf_mul(f, a[col])
                out[r] ^= gf_mul(f, out[col])
    return out


def rs_coefficients(width: int, n_parity: int) -> np.ndarray:
    """(n_parity, width) Cauchy encode matrix, row 0 scaled to ones:
    parity row ``r`` of a group is ``XOR_i gf_mul(C[r, i], D_i)`` over its
    members. ``width + n_parity <= 256`` (one field element per codeword
    position)."""
    if width + n_parity > 256:
        raise ValueError(
            f"RS({width}, {n_parity}) exceeds GF(256): width + parity "
            "count must be <= 256")
    x = np.arange(n_parity, dtype=np.int32)            # parity positions
    y = np.arange(width, dtype=np.int32) + n_parity    # member positions
    c = gf_inv(x[:, None] ^ y[None, :])                # Cauchy: 1/(x ^ y)
    return gf_mul(c, gf_inv(c[0])[None, :])            # row 0 -> all ones


def rs_decode_weights(coeff: np.ndarray, erased: np.ndarray,
                      survivors: np.ndarray,
                      parity_rows: np.ndarray) -> np.ndarray:
    """Decode weights of one group's erasure pattern.

    ``coeff``: the (m, width) encode matrix; ``erased``: the member slots
    to solve for (e <= len(parity_rows)); ``survivors``: the slots with
    trusted frames; ``parity_rows``: the rows to fold (the first e are
    used). Returns ``(e, width + m)`` weights ``W``: erased member ``q``'s
    frame is ``XOR_i gf_mul(W[q, i], member_i) XOR_r gf_mul(W[q, width +
    r], parity_r)``."""
    m, width = coeff.shape
    erased = np.asarray(erased, np.int64)
    rows = np.asarray(parity_rows, np.int64)[:erased.size]
    a_inv = gf_mat_inv(coeff[np.ix_(rows, erased)])
    w = np.zeros((erased.size, width + m), np.int32)
    for q in range(erased.size):
        for ri, r in enumerate(rows):
            w[q, width + int(r)] ^= a_inv[q, ri]
            for i in np.asarray(survivors, np.int64):
                w[q, int(i)] ^= gf_mul(a_inv[q, ri], coeff[int(r), int(i)])
    return w
