"""CUDA kernel: XOR parity rows read straight from the flat word arena.

Replaces ``repro/kernels/parity_xor/kernel.py::parity_xor_pallas``. The
source, with its design note, is ``repro_torch/csrc/parity_xor.cu`` (its
body, shared with gf256_mac, in ``csrc/erasure_pieces.cuh``): the
reference's ``base ^ XOR of the kept member frames`` with every member
frame read where its words lie in the arena, so no frames buffer exists.
The kernel runs on the plan's pieces
(:func:`~repro_torch.kernels.parity_xor.ops.build_pieces`), one CTA per
tile."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

TILE_WORDS = 32768     # output words of one piece that one CTA folds

_KEYS = ("pc_out", "pc_length", "pc_base", "pc_term_ptr", "pc_term_src",
         "pc_tile_piece", "pc_tile_lo")


def parity_xor_cuda(out: torch.Tensor, src: torch.Tensor,
                    base, t: dict) -> torch.Tensor:
    """Row ``r`` of the plan whose pieces' tables are ``t``
    (:meth:`ParityPlan.pieces_on
    <repro_torch.kernels.parity_xor.ops.PiecedPlan.pieces_on>`) writes
    ``out[row_out[r]:row_out[r] + row_len[r]]``: the words of ``base`` at
    ``row_base[r]`` (zeros where it is -1) XOR every term of the row. out,
    src, base: 1-D int32 CUDA tensors on one device (``base`` may be None
    when no row has a base). Returns ``out``."""
    dev = out.device
    if dev.type != "cuda":
        raise ValueError(f"parity_xor_cuda needs CUDA tensors, got {dev}")
    for name, a in (("out", out), ("src", src), ("base", base)):
        if a is None:
            continue
        if a.device != dev or a.dtype != torch.int32 or a.dim() != 1 \
                or not a.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D int32 tensor "
                             f"on {dev}")
    if int(t["out_words"]) > out.numel() \
            or int(t["src_words"]) > src.numel():
        raise ValueError("the plan reads or writes past its buffers")
    if int(t["base_words"]) > (0 if base is None else base.numel()):
        raise ValueError("the plan reads past the base buffer")
    n_tiles = int(t["n_tiles"])
    if n_tiles == 0:
        return out
    if any(t[k].device != dev for k in _KEYS):
        raise ValueError(f"the plan's tables are not on {dev}")
    lib = _build.library()
    _build.launch("parity_xor", lib.parity_xor, dev, out.data_ptr(),
                  src.data_ptr(), None if base is None else base.data_ptr(),
                  *(t[k].data_ptr() for k in _KEYS), n_tiles,
                  int(t["tile_words"]))
    return out
