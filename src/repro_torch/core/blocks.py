"""Deterministic block partition of a parameter tree.

The port of ``repro.core.blocks``. The unit of loss, checkpoint and
priority is a **block**: ``block_rows`` consecutive leading-dim rows of
each leaf. A ``BlockPartition`` is the static, host-side description of
that blocking; every runtime operation over blocks takes it as a
parameter.

Layout per leaf ``x`` of shape ``(d0, d1, ..., dn)``:
  rows      = d0              (ndim >= 1; scalars are treated as 1 row)
  row_width = prod(d1..dn)
  n_blocks  = ceil(rows / block_rows)
Blocks of a leaf are contiguous row groups; global block ids concatenate
leaves in JAX's flatten order (:mod:`repro_torch.utils.tree`), so the two
packages number every block the same way. Padding rows (to fill the last
block) are zeros on both sides of any distance computation, so they never
affect scores.

Word packing (the flat arena and the parity frames): a block's payload is
stored as 32-bit words, ``dtype_word_ratio`` elements per word, element 0
in the low-order bytes, as the reference packs it. The port carries words
as ``torch.int32`` and bitcasts with ``Tensor.view`` (the reference carries
them as float32).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.kernels.block_dist.ops import tree_block_scores
from repro_torch.utils.tree import (TreeDef, flatten_with_path, keystr,
                                    tree_leaves)

PyTree = Any


@dataclasses.dataclass(frozen=True)
class LeafMeta:
    name: str
    shape: tuple[int, ...]
    dtype: Any
    rows: int
    row_width: int
    n_blocks: int
    offset: int            # global block-id offset of this leaf's first block


@dataclasses.dataclass(frozen=True)
class BlockPartition:
    block_rows: int
    leaves: tuple[LeafMeta, ...]
    treedef: TreeDef

    @property
    def total_blocks(self) -> int:
        # colocated leaves share offsets, so count by extent not by sum
        return max(l.offset + l.n_blocks for l in self.leaves)

    @property
    def total_params(self) -> int:
        return sum(int(np.prod(l.shape)) if l.shape else 1 for l in self.leaves)

    def blocks_for_k(self, fraction: float) -> int:
        """Number of blocks in a fraction-r checkpoint (ceil, >= 1)."""
        return max(1, math.ceil(fraction * self.total_blocks))


def partition_pytree(params: PyTree, block_rows: int = 128,
                     colocate: tuple = ()) -> BlockPartition:
    """Build the static block partition for ``params`` (shapes only).

    ``colocate``: top-level keys whose subtrees share block ids with each
    other (matching by the remaining path): a failed partition loses a
    weight block and its optimizer moments together, and partial recovery
    restores them together. E.g. state = {"net": ..., "mu": ..., "nu": ...}
    with colocate=("net", "mu", "nu"): mu's and nu's leaves reuse net's
    blocks.
    """
    flat, treedef = flatten_with_path(params)
    leaves = []
    offset = 0
    canonical_offsets: dict = {}
    for path, x in flat:
        shape = tuple(x.shape)
        rows = shape[0] if len(shape) >= 1 else 1
        row_width = int(np.prod(shape[1:])) if len(shape) >= 1 else 1
        n_blocks = max(1, math.ceil(rows / block_rows))
        name = keystr(path)
        leaf_offset = offset
        if colocate and path and path[0][0] == "key" \
                and path[0][1] in colocate:
            canon = keystr(path[1:])
            if canon in canonical_offsets:
                leaf_offset, prev_blocks = canonical_offsets[canon]
                if prev_blocks != n_blocks:
                    raise ValueError(
                        f"colocated leaf {name} has {n_blocks} blocks, "
                        f"group has {prev_blocks}")
            else:
                canonical_offsets[canon] = (offset, n_blocks)
                offset += n_blocks
        else:
            offset += n_blocks
        leaves.append(LeafMeta(
            name=name, shape=shape, dtype=x.dtype, rows=rows,
            row_width=row_width, n_blocks=n_blocks, offset=leaf_offset))
    return BlockPartition(block_rows=block_rows, leaves=tuple(leaves),
                          treedef=treedef)


# The word-packable dtypes: 1/2/4-byte ints and floats, stored in words as
# raw bit patterns. A dtype's index here is its arena dtype code (0 = f32);
# the arena_maintain kernel decodes by these codes, so the order is fixed.
# Names the installed torch lacks are skipped by ``word_packable``.
WORD_DTYPE_NAMES = ("float32", "bfloat16", "float16", "float8_e4m3fn",
                    "float8_e5m2", "float8_e4m3fnuz", "float8_e5m2fnuz",
                    "float8_e8m0fnu", "int8", "uint8", "int16", "uint16",
                    "int32", "uint32")
_WORD_DTYPES = {getattr(torch, n): n for n in WORD_DTYPE_NAMES
                if hasattr(torch, n)}
_BITS = {1: torch.int8, 2: torch.int16, 4: torch.int32}


def leaf_frame_width(leaf: LeafMeta, block_rows: int) -> int:
    """Payload elements per block of this leaf: the width of its
    :func:`leaf_block_view` rows (single-block leaves are unpadded), and so
    the per-block payload of the parity frames and of the flat arena."""
    if leaf.n_blocks == 1:
        return max(leaf.rows, 1) * max(leaf.row_width, 1)
    return block_rows * leaf.row_width


def word_packable(dtype: torch.dtype) -> bool:
    """True when ``dtype`` values are stored in words as raw bit patterns
    (f32, bf16, f16, the fp8 family, int8/16/32, uint8/16/32). Everything
    else (f64, int64, complex, bool) keeps the one-f32-image-per-element
    convention."""
    return dtype in _WORD_DTYPES


def dtype_word_ratio(dtype: torch.dtype) -> int:
    """Elements per 32-bit word: 1 (f32/i32), 2 (bf16/f16/i16), 4
    (fp8/i8); 1 for dtypes that are not word-packable."""
    return 4 // dtype.itemsize if word_packable(dtype) else 1


def leaf_word_width(leaf: LeafMeta, block_rows: int) -> int:
    """Payload 32-bit words per block of this leaf: its
    :func:`leaf_frame_width` elements packed ``dtype_word_ratio`` per word
    (the sub-word tail padded with zero bits)."""
    r = dtype_word_ratio(leaf.dtype)
    return -(-leaf_frame_width(leaf, block_rows) // r)


def leaf_block_words(x: torch.Tensor, block_rows: int) -> torch.Tensor:
    """(n_blocks, payload_words) int32 raw bit pattern of a leaf's blocks,
    ``dtype_word_ratio`` consecutive elements per word, element 0 in the
    low-order bytes (numpy's ``.view(int32)`` on a little-endian host).
    Dtypes that are not word-packable store one f32 image per word."""
    if not word_packable(x.dtype):
        x = x.to(torch.float32)
    # bitcast first: the zero padding is then zero bits for every dtype
    bits = leaf_block_view(x.view(_BITS[x.dtype.itemsize]),
                           block_rows).contiguous()
    tail = -bits.shape[1] % (4 // x.dtype.itemsize)
    if tail:
        bits = torch.cat([bits, bits.new_zeros((bits.shape[0], tail))], 1)
    return bits.view(torch.int32)


def words_to_elems(words: torch.Tensor, dtype: torch.dtype,
                   elems: int) -> torch.Tensor:
    """(n, >= ceil(elems / ratio)) int32 words -> (n, elems) values of
    ``dtype``: the inverse of the packing, bit-exact for word-packable
    dtypes and a value cast through f32 otherwise."""
    r = dtype_word_ratio(dtype)
    w = words[:, :-(-elems // r)].contiguous()
    if not word_packable(dtype):
        return w.view(torch.float32)[:, :elems].to(dtype)
    if r > 1:
        w = w.view(_BITS[dtype.itemsize])
    return w.view(dtype)[:, :elems]


def decode_block_words(words: torch.Tensor, leaf: LeafMeta,
                       block_rows: int) -> torch.Tensor:
    """Inverse of :func:`leaf_block_words`: ``(n_blocks, >= payload_words)``
    int32 words back to the leaf-shaped tensor."""
    vals = words_to_elems(words, leaf.dtype,
                          leaf_frame_width(leaf, block_rows))
    rows = max(leaf.rows, 1)
    vals = vals.reshape(-1, max(leaf.row_width, 1))[:rows]
    return vals.reshape(leaf.shape)


def leaf_block_view(x: torch.Tensor, block_rows: int) -> torch.Tensor:
    """Reshape a leaf to (n_blocks, elems_per_block), zero-padded.

    Single-block leaves (rows <= block_rows) are returned unpadded as
    (1, rows*row_width). A leaf whose rows fill its blocks exactly comes
    back as a view; only a ragged multi-block leaf is copied (to pad it).
    """
    if x.dim() == 0:
        x = x.reshape(1)
    rows = x.shape[0]
    row_width = int(np.prod(x.shape[1:])) if x.dim() > 1 else 1
    flat = x.reshape(rows, row_width)
    n_blocks = max(1, math.ceil(rows / block_rows))
    if n_blocks == 1:
        return flat.reshape(1, rows * row_width)
    pad = n_blocks * block_rows - rows
    if pad:
        flat = torch.cat([flat, flat.new_zeros((pad, row_width))])
    return flat.reshape(n_blocks, block_rows * row_width)


def split_global_mask(mask: torch.Tensor,
                      partition: BlockPartition) -> list[torch.Tensor]:
    """Split a (total_blocks,) vector into per-leaf (n_blocks,) segments."""
    return [mask[l.offset:l.offset + l.n_blocks] for l in partition.leaves]


def expand_block_mask(block_mask: torch.Tensor, leaf: LeafMeta,
                      block_rows: int) -> torch.Tensor:
    """(n_blocks,) bool -> bool tensor broadcastable to the leaf shape.

    Expands over rows then broadcasts across trailing dims.
    """
    row_mask = torch.repeat_interleave(block_mask, block_rows)[:leaf.rows]
    if len(leaf.shape) == 0:
        return row_mask[0]
    return row_mask.reshape((leaf.rows,) + (1,) * (len(leaf.shape) - 1))


def select_blocks(dst: PyTree, src: PyTree, global_mask: torch.Tensor,
                  partition: BlockPartition) -> PyTree:
    """Per-block select: where mask is True take ``src``'s block, else ``dst``.

    This is the primitive behind both partial recovery (dst=live params,
    src=checkpoint, mask=lost blocks) and the ``inplace_save=False``
    partial save (dst=checkpoint values, src=live params, mask=selected
    blocks). It runs as the masked_restore kernel on CUDA tensors, the
    drop-in the JAX package documents for it, and as its plain version on
    CPU tensors.
    """
    from repro_torch.kernels.masked_restore.ops import tree_masked_restore
    return tree_masked_restore(dst, src, global_mask, partition)


def block_scores(a: PyTree, b: PyTree, partition: BlockPartition,
                 norm_fn: Callable[[torch.Tensor, torch.Tensor, LeafMeta],
                                   torch.Tensor],
                 ) -> torch.Tensor:
    """Per-block distance scores between two trees -> (total_blocks,) f32.

    ``norm_fn(a_view, b_view, leaf)`` maps two (n_blocks, block_elems) views
    to per-block scores; see :mod:`repro_torch.core.norms`. Colocated
    leaves (shared offsets) accumulate into the same slots. A norm with a
    whole-tree form (``norm_fn.tree(a_leaves, b_leaves, partition)``, the
    l2 norm's grouped kernel) is handed the leaves in one call instead.
    """
    a_flat = tree_leaves(a)
    b_flat = tree_leaves(b)
    tree_fn = getattr(norm_fn, "tree", None)
    if tree_fn is not None:
        return tree_fn(a_flat, b_flat, partition)
    out = torch.zeros((partition.total_blocks,), dtype=torch.float32,
                      device=a_flat[0].device)
    for xa, xb, leaf in zip(a_flat, b_flat, partition.leaves):
        va = leaf_block_view(xa.to(torch.float32), partition.block_rows)
        vb = leaf_block_view(xb.to(torch.float32), partition.block_rows)
        s = norm_fn(va, vb, leaf).to(torch.float32)
        out[leaf.offset:leaf.offset + leaf.n_blocks] += s
    return out


def masked_total(per_block: torch.Tensor,
                 global_mask: torch.Tensor) -> torch.Tensor:
    """Sum of ``per_block`` over the blocks ``global_mask`` selects."""
    return torch.sum(torch.where(global_mask.to(torch.bool), per_block,
                                 torch.zeros_like(per_block)))


def masked_sq_norm(a: PyTree, b: PyTree, global_mask: torch.Tensor,
                   partition: BlockPartition) -> torch.Tensor:
    """||(a - b) restricted to masked blocks||^2 -- the delta' of Theorem 4.1
    (the per-block distances in one grouped block_dist call on the card)."""
    return masked_total(tree_block_scores(a, b, partition), global_mask)


def tree_sq_norm(a: PyTree, b: PyTree) -> torch.Tensor:
    """||a - b||^2 over the whole tree -- the delta of full recovery."""
    total = None
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        d = torch.sum((x.to(torch.float32) - y.to(torch.float32)) ** 2)
        total = d if total is None else total + d
    if total is None:
        return torch.zeros((), dtype=torch.float32)
    return total


class ReplayDraws:
    """Random block draws recorded elsewhere (e.g. the reference's, as
    numpy block ids), handed out in order where a controller's generator
    would draw them: each failure mask and each RANDOM-strategy save takes
    the next one (:func:`random_blocks`). ``seed`` stands for the
    generator's seed, which also seeds the controller's numpy generator of
    domain failures."""

    def __init__(self, draws, seed: int = 0):
        self._draws = [np.asarray(d, np.int64) for d in draws]
        self._seed = int(seed)

    def initial_seed(self) -> int:
        return self._seed

    def next(self, total: int, k: int) -> torch.Tensor:
        if not self._draws:
            raise ValueError("the recorded draws are used up")
        ids = self._draws.pop(0)
        if ids.size != k or (ids.size and (ids.min() < 0
                                           or ids.max() >= total)):
            raise ValueError(f"the next recorded draw has {ids.size} block "
                             f"ids, not {k} of {total}")
        return torch.from_numpy(ids)


def random_blocks(rng, total: int, k: int) -> torch.Tensor:
    """``k`` of ``total`` block ids uniformly at random (int64, on the CPU),
    drawn with ``rng``: a CPU ``torch.Generator``, or a
    :class:`ReplayDraws` handing out its next recorded draw."""
    if isinstance(rng, ReplayDraws):
        return rng.next(total, k)
    return torch.randperm(total, generator=rng)[:k]
