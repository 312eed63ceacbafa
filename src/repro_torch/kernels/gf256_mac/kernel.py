"""CUDA kernel: GF(256) multiply-accumulate read in place from the arena.

Replaces ``repro/kernels/gf256_mac/kernel.py::gf256_mac_pallas``. The
source, with its design note and its bound, is
``repro_torch/csrc/gf256_mac.cu`` (its body, shared with parity_xor, in
``csrc/erasure_pieces.cuh``): the reference's ``base ^ XOR_i
gf_mul(coeff_i, frame_i)`` with every member frame read where its words lie
(in the arena, or in the stored parity rows for a decode) and all m parity
rows of a group produced by one read of its members. The kernel runs on the
plan's pieces (:meth:`GFPlan.pieces
<repro_torch.kernels.gf256_mac.ops.GFPlan.pieces>`), one CTA per tile.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

_KEYS = ("pc_out", "pc_length", "pc_base", "pc_term_ptr", "pc_term_src",
         "pc_sel", "pc_coef", "pc_tile_piece", "pc_tile_lo")


def gf256_mac_cuda(out: torch.Tensor, src: torch.Tensor, src2, base,
                   plan, row0: int = 0, n_rows=None,
                   out_shift: int = 0) -> torch.Tensor:
    """Rows ``[row0, row0 + n_rows)`` (default: all) of ``plan`` (a
    :class:`~repro_torch.kernels.gf256_mac.ops.GFPlan`), written into
    ``out`` at the rows' offsets less ``out_shift``. out, src, src2, base:
    1-D int32 CUDA tensors on one device; ``src2`` (the terms with
    selector 1) and ``base`` may be None where no term or row reads them.
    Returns ``out``."""
    dev = out.device
    if dev.type != "cuda":
        raise ValueError(f"gf256_mac_cuda needs CUDA tensors, got {dev}")
    for name, a in (("out", out), ("src", src), ("src2", src2),
                    ("base", base)):
        if a is None:
            continue
        if a.device != dev or a.dtype != torch.int32 or a.dim() != 1 \
                or not a.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D int32 tensor "
                             f"on {dev}")
    n_rows = plan.n_rows - row0 if n_rows is None else int(n_rows)
    if row0 < 0 or n_rows < 0 or row0 + n_rows > plan.n_rows:
        raise ValueError(f"rows [{row0}, {row0 + n_rows}) outside the plan's "
                         f"{plan.n_rows}")
    lim = plan.limits(row0, n_rows)
    if lim["out_lo"] < out_shift or lim["out_hi"] - out_shift > out.numel():
        raise ValueError("the plan writes outside the output buffer")
    for name, a, need in (("src", src, lim["src_words"]),
                          ("src2", src2, lim["src2_words"]),
                          ("base", base, lim["base_words"])):
        if need > (0 if a is None else a.numel()):
            raise ValueError(f"the plan reads past the {name} buffer")
    lib = _build.library()
    if not 1 <= plan.m <= lib.gf256_mac_max_m():
        raise ValueError(f"{plan.m} outputs per row; the kernel takes 1 to "
                         f"{lib.gf256_mac_max_m()}")
    pc = plan.pieces()
    t0, t1 = pc.tiles(row0, n_rows)
    if t1 == t0:
        return out
    t = plan.pieces_on(dev)

    def ptr(a):
        return None if a is None else a.data_ptr()

    _build.launch("gf256_mac", lib.gf256_mac, dev, out.data_ptr(),
                  src.data_ptr(), ptr(src2), ptr(base),
                  *(t[k].data_ptr() for k in _KEYS), plan.m, plan.out_stride,
                  plan.base_stride, out_shift, t0, t1 - t0, pc.tile_words)
    return out
