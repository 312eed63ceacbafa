"""CUDA kernels of the maintenance family.

- ``scatter_save_cuda`` replaces
  ``repro/kernels/fused_maintain/kernel.py::scatter_save_pallas``
  (source and design note: ``repro_torch/csrc/scatter_save.cu``);
- ``arena_maintain_cuda`` replaces ``arena_maintain_pallas``
  (``repro_torch/csrc/arena_maintain.cu``);
- ``arena_scatter_cuda`` replaces ``arena_scatter_pallas``
  (``repro_torch/csrc/arena_scatter.cu``);
- ``fused_maintain_cuda`` replaces ``fused_maintain_pallas``, the per-leaf
  sweep (``repro_torch/csrc/fused_maintain.cu``).
"""
from __future__ import annotations

import torch

from repro_torch.core.arena import dtype_code
from repro_torch.core.blocks import (WORD_DTYPE_NAMES, dtype_word_ratio,
                                     word_packable)
from repro_torch.kernels import _build


def scatter_save_cuda(dst: torch.Tensor, src: torch.Tensor,
                      rows: torch.Tensor, block_rows: int) -> torch.Tensor:
    """Copy block ``b`` (rows ``[b*block_rows, (b+1)*block_rows)``, the last
    block ragged) of ``src`` into ``dst`` for every id in ``rows``, in
    place. dst, src: (R, W) contiguous CUDA tensors of one dtype; rows:
    (k,) int32 on the same device, each in ``[0, ceil(R / block_rows))``.
    Returns ``dst``."""
    if dst.device.type != "cuda" or src.device != dst.device \
            or rows.device != dst.device:
        raise ValueError(f"scatter_save_cuda needs dst, src and rows on one "
                         f"CUDA device, got {dst.device}, {src.device}, "
                         f"{rows.device}")
    if src.dtype != dst.dtype:
        raise TypeError(f"dtypes differ: {dst.dtype} and {src.dtype}")
    if rows.dtype != torch.int32 or rows.dim() != 1:
        raise TypeError("rows must be a 1-D int32 tensor")
    if dst.dim() != 2 or dst.shape != src.shape:
        raise ValueError(f"need equal (R, W) shapes, got {tuple(dst.shape)} "
                         f"and {tuple(src.shape)}")
    if not (dst.is_contiguous() and src.is_contiguous()
            and rows.is_contiguous()):
        raise ValueError("scatter_save_cuda needs contiguous tensors")
    if block_rows < 1:
        raise ValueError("block_rows must be >= 1")
    r, w = dst.shape
    item = dst.element_size()
    block_bytes = block_rows * w * item
    total_bytes = r * w * item
    k = rows.shape[0]
    if k == 0 or total_bytes == 0:
        return dst
    if -(-block_bytes // _build.COPY_CHUNK_BYTES) > _build.MAX_GRID_Y:
        raise ValueError(f"block of {block_bytes} bytes is too large")
    _build.launch("scatter_save", _build.library().scatter_save_bytes,
                  dst.device, dst.data_ptr(), src.data_ptr(), rows.data_ptr(),
                  k, block_bytes, total_bytes)
    return dst


# the arena_maintain kernel decodes every code of core/blocks.py's
# WORD_DTYPE_NAMES (its switch in csrc/arena_maintain.cu follows that
# order); a larger code has no decoder there
MAX_DTYPE_CODE = len(WORD_DTYPE_NAMES) - 1


def _check_arena(name: str, t: torch.Tensor, device) -> None:
    if t.device != device or t.dtype != torch.int32 or t.dim() != 1 \
            or not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be a contiguous, 16-byte aligned 1-D "
                         f"int32 tensor on {device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def arena_maintain_cuda(x: torch.Tensor, z, t: dict, parity=None,
                        replica=None):
    """One arena sweep (see ``csrc/arena_maintain.cu``).

    x: the live arena, (total_words,) int32 on a CUDA device. z: the
    checkpoint arena of the same shape, or None (no scores). ``t``: the
    sweep plan's tables on that device
    (:meth:`repro_torch.kernels.fused_maintain.ops.SweepPlan.on`).
    parity: the (n_groups * frame_elems) int32 parity to write, or None;
    replica: an arena-shaped int32 tensor to receive the routed tiles'
    copy, or None. Returns the (total_blocks,) f32 scores, or None without
    ``z``."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"arena_maintain_cuda needs a CUDA arena, got {dev}")
    n_tiles = int(t["n_tiles"])
    _check_arena("x", x, dev)
    if x.numel() != n_tiles * 1024:
        raise ValueError(f"x has {x.numel()} words, the plan {n_tiles} tiles")
    for name, a in (("z", z), ("replica", replica)):
        if a is not None:
            _check_arena(name, a, dev)
            if a.numel() != x.numel():
                raise ValueError(f"{name} and x differ in size")
    if parity is not None:
        _check_arena("parity", parity, dev)
        if t["dest_tile"].numel() and \
                int(t["max_dest_tile"]) >= parity.numel() // 1024:
            raise ValueError("the plan writes past the parity buffer")
    if int(t["max_code"]) > MAX_DTYPE_CODE:
        raise ValueError(f"dtype code {int(t['max_code'])} has no decoder in "
                         f"the arena_maintain kernel")
    n_dest = t["dest_tile"].numel()
    n_tb = t["tb_off"].numel()
    n_gid = t["gid_ptr"].numel() - 1
    scores = partials = None
    if z is not None:
        partials = torch.empty((n_tiles + n_tb,), dtype=torch.float32,
                               device=dev)
        scores = torch.empty((n_gid,), dtype=torch.float32, device=dev)

    def ptr(a):
        return None if a is None else a.data_ptr()

    _build.launch(
        "arena_maintain", _build.library().arena_maintain, dev, x.data_ptr(),
        ptr(z), ptr(replica), ptr(parity), ptr(partials), ptr(scores),
        *(t[k].data_ptr() for k in ("tile_code", "dest_tile", "mem_ptr",
                                    "mem_tile", "tail_ptr", "tail_pos",
                                    "tail_word")),
        n_dest, t["tb_off"].data_ptr(), t["tb_len"].data_ptr(),
        t["tb_code"].data_ptr(), n_tb, n_tiles,
        *(t[k].data_ptr() for k in ("gid_ptr", "gid_ab", "ab_seg0",
                                    "ab_nseg")), n_gid)
    return scores


def arena_scatter_cuda(dst: torch.Tensor, src: torch.Tensor,
                       t: dict) -> torch.Tensor:
    """Copy the word ranges of the plan ``t`` (:func:`scatter_plan
    <repro_torch.kernels.fused_maintain.ops.scatter_plan>` on this device)
    from ``src`` into ``dst`` in place, in one launch. dst, src:
    (total_words,) int32 on one CUDA device. Returns ``dst``."""
    dev = dst.device
    if dev.type != "cuda":
        raise ValueError(f"arena_scatter_cuda needs a CUDA arena, got {dev}")
    _check_arena("dst", dst, dev)
    _check_arena("src", src, dev)
    if src.numel() != dst.numel():
        raise ValueError("dst and src differ in size")
    if int(t["end_word"]) > dst.numel():
        raise ValueError("a range lies outside the arena")
    if t["chunk_range"].device != dev:
        raise ValueError(f"the plan lies on {t['chunk_range'].device}")
    n_chunks = t["chunk_range"].numel()
    if n_chunks == 0:
        return dst
    _build.launch("arena_scatter", _build.library().arena_scatter, dev,
                  dst.data_ptr(), src.data_ptr(),
                  *(t[k].data_ptr() for k in ("off", "len", "chunk_ptr",
                                              "chunk_range")), n_chunks)
    return dst


# the fused_maintain kernel's element loaders (csrc/fused_maintain.cu): the
# word-packable dtypes by element size, the rest by the f32 image it stores
_IMAGE_LOADERS = {torch.bool: 5, torch.float64: 6, torch.int64: 7,
                  torch.complex64: 8, torch.complex128: 9}


def fused_maintain_loader(dtype: torch.dtype) -> int:
    """The fused_maintain kernel's loader for leaves of ``dtype``; raises
    TypeError for a dtype it does not take."""
    if dtype in _IMAGE_LOADERS:
        return _IMAGE_LOADERS[dtype]
    if word_packable(dtype):
        return dtype.itemsize
    raise TypeError(f"the fused_maintain kernel does not take {dtype}")


def fused_maintain_cuda(x: torch.Tensor, z, parity, t: dict,
                        block_rows: int, col: int, frame_elems: int,
                        replica=None):
    """One leaf's sweep (see ``csrc/fused_maintain.cu``): returns ``(replica,
    scores)`` and XORs the leaf's parity into ``parity`` in place.

    x: the live leaf, a contiguous CUDA tensor of a word-packable dtype or
    of bool, f64, int64, complex64 or complex128 (their f32 images go into
    the parity and the scores); z: the checkpoint leaf of the same dtype
    and shape, or None (no scores: None is returned for them). parity: the
    flat ``(n_groups * frame_elems)`` int32 parity, or None. ``t``: the
    leaf's :class:`~repro_torch.kernels.fused_maintain.ops.LeafGroupMeta`
    tables on the device (``ops.leaf_tables``), ``col`` its frame column.
    replica: a contiguous tensor like ``x`` to write the copy into, or None
    (a new one)."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"fused_maintain_cuda needs a CUDA leaf, got {dev}")
    loader = fused_maintain_loader(x.dtype)
    if not x.is_contiguous():
        raise ValueError("fused_maintain_cuda needs a contiguous leaf")
    for name, a in (("z", z), ("replica", replica)):
        if a is not None and (a.device != dev or a.dtype != x.dtype
                              or a.shape != x.shape
                              or not a.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous tensor of x's "
                             f"device, dtype and shape")
    numel = x.numel()
    rows = x.shape[0] if x.dim() else 1
    row_width = numel // rows if rows else 0
    n_blocks = max(1, -(-rows // block_rows))
    elems = rows * row_width if n_blocks == 1 else block_rows * row_width
    width = -(-elems // dtype_word_ratio(x.dtype))
    if width != int(t["width"]) or n_blocks != int(t["n_blocks"]):
        raise ValueError("the tables were built for another leaf shape")
    if parity is not None:
        if parity.device != dev or parity.dtype != torch.int32 \
                or parity.dim() != 1 or not parity.is_contiguous():
            raise ValueError("parity must be a contiguous 1-D int32 tensor "
                             f"on {dev}")
        if col + width > frame_elems or (int(t["max_touched"]) + 1) \
                * frame_elems > parity.numel():
            raise ValueError("the leaf's rows lie outside the parity")
    if replica is None:
        replica = torch.empty_like(x)
    scores = partials = None
    lib = _build.library()
    n_chunks = lib.fused_maintain_chunks(width)
    if n_chunks > _build.MAX_GRID_Y:
        raise ValueError(f"a block of {width} words is too long")
    if z is not None:
        partials = torch.empty((n_blocks * n_chunks,), dtype=torch.float32,
                               device=dev)
        scores = torch.empty((n_blocks,), dtype=torch.float32, device=dev)
    if numel == 0:
        return replica, (None if z is None else scores.zero_())

    def ptr(a):
        return None if a is None else a.data_ptr()

    _build.launch("fused_maintain", lib.fused_maintain, dev, x.data_ptr(),
                  ptr(z), replica.data_ptr(), ptr(parity), ptr(partials),
                  ptr(scores), t["members"].data_ptr(),
                  t["touched"].data_ptr(), int(t["n_out"]), int(t["m_hat"]),
                  n_blocks, elems, numel, width, col, frame_elems, loader,
                  dtype_code(x.dtype))
    return replica, scores
