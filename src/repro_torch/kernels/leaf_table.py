"""Leaf tables of the grouped whole-tree kernels (block_dist, scatter_save,
masked_restore).

A tree of L leaves costs the per-leaf kernels L wrapper calls and L
launches; the grouped kernels walk a table of the leaves in device memory
in one launch, the way a grouped GEMM walks its pointer array. This module
builds those tables with numpy (nothing here needs a card, so the CPU tests
reach all of it) and stages them to the card:

- :class:`BlockDistTable`: block_dist's work list and finish CSR, static
  per partition (:func:`block_dist_table`, cached per partition), and
  :func:`dist_pointers`, its pointer column for one call;
- :func:`save_pairs` and :func:`scatter_table`: scatter_save's selected
  (leaf, block) pairs and its table of leaves, pairs and work items, built
  anew for every save;
- :class:`RestoreTable`: masked_restore's work list, static per partition
  and leaf dtypes (:func:`restore_table`), and :func:`restore_call`, one
  restore's pointer column and output tensors;
- :func:`upload`: host-to-device copies of small int64 tables from
  page-locked buffers on the current stream.

The chunk sizes mirror ``csrc/block_dist.cu`` (``kChunk``) and
``csrc/byte_copy.cuh`` (``kCopyChunk``).
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import TYPE_CHECKING, Callable, Hashable, Optional

import numpy as np
import torch

from repro_torch.kernels import _build

if TYPE_CHECKING:   # core.blocks imports the block_dist ops, and so this
    from repro_torch.core.blocks import BlockPartition

BLOCK_DIST_CHUNK = 8192                    # elements per pass-1 CTA
BF16_FLAG = 1                              # block_dist.cu's kBf16Flag
COPY_CHUNK_BYTES = _build.COPY_CHUNK_BYTES  # bytes per byte-copy CTA
MAX_ITEMS = 2**31 - 1                      # gridDim.x


# tables built once per partition object: id(partition) -> {key: table};
# an entry goes when its partition is freed (a copy builds its own)
_PER_PARTITION: dict[int, dict] = {}


def per_partition(partition: BlockPartition, key: Hashable,
                  make: Callable[[], object]):
    """``make()``, built once per partition object and ``key``."""
    memo = _PER_PARTITION.get(id(partition))
    if memo is None:
        memo = _PER_PARTITION[id(partition)] = {}
        weakref.finalize(partition, _PER_PARTITION.pop, id(partition), None)
    hit = memo.get(key)
    if hit is None:
        hit = memo[key] = make()
    return hit


@dataclasses.dataclass(frozen=True, eq=False)
class LeafArrays:
    """A partition's per-leaf geometry as int64 arrays, and each leaf's
    number of values as a list of ints (checked against tensors)."""
    offset: np.ndarray
    n_blocks: np.ndarray
    rows: np.ndarray
    row_width: np.ndarray
    itemsize: np.ndarray
    numel: list


def leaf_arrays(partition: BlockPartition) -> LeafArrays:
    def make():
        ls = partition.leaves
        return LeafArrays(
            *(np.array([getattr(l, f) for l in ls], np.int64)
              for f in ("offset", "n_blocks", "rows", "row_width")),
            itemsize=np.array([l.dtype.itemsize for l in ls], np.int64),
            numel=[l.rows * l.row_width for l in ls])
    return per_partition(partition, "leaf_arrays", make)


def _pack(parts: dict) -> tuple[np.ndarray, dict]:
    """int64 arrays as one flat int64 array, and each one's offset in it
    (in elements)."""
    offsets, at = {}, 0
    for name, a in parts.items():
        offsets[name] = at
        at += a.size
    return (np.concatenate([a.ravel() for a in parts.values()])
            .astype(np.int64), offsets)


def _int32_pairs(a: np.ndarray) -> np.ndarray:
    """An int32 list as int64 elements, two to an element (zero-padded)."""
    out = np.zeros((-(-a.size // 2) * 2,), np.int32)
    out[:a.size] = a
    return out.view(np.int64)


def _stream_key(device: torch.device) -> tuple:
    return device, torch.cuda.current_stream(device).cuda_stream


# ---------------------------------------------------------------------------
# block_dist
# ---------------------------------------------------------------------------

@dataclasses.dataclass(eq=False)
class BlockDistTable:
    """block_dist's grouped work over one partition (numpy).

    Leaf ``l`` is ``numel[l]`` f32 values read in place; its block ``k`` is
    elements ``[k * block_elems[l], min((k + 1) * block_elems[l],
    numel[l]))`` (a single-block leaf is one block of all its values, as
    ``leaf_block_view`` has it), cut into ``cpb[l]`` chunks of
    ``BLOCK_DIST_CHUNK``. Work item ``g`` (one CTA, one partial) is chunk
    ``c`` of block ``k`` of leaf ``item_leaf[g]``, where ``g -
    item_start[l] = k * cpb[l] + c``; a ragged last block's surplus items
    read nothing. Global block ``j``'s segments are ``seg_start[j] ..
    seg_start[j + 1]``, one per leaf that holds ``j``, in leaf order: segment
    ``s`` is the partials ``seg_first[s] .. seg_first[s] + seg_count[s]``.
    """
    chunk: int              # elements per work item
    total_blocks: int
    n_items: int
    numel: list             # per leaf, as Python ints (checked per call)
    item_start: np.ndarray  # int64 (L,)
    cpb: np.ndarray         # int64 (L,)
    block_elems: np.ndarray  # int64 (L,)
    item_leaf: np.ndarray   # int32 (n_items,)
    seg_start: np.ndarray   # int64 (total_blocks + 1,)
    seg_first: np.ndarray   # int64 (n_segs,)
    seg_count: np.ndarray   # int64 (n_segs,)
    _on: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def n_leaves(self) -> int:
        return len(self.numel)

    def packed(self) -> tuple[np.ndarray, dict]:
        """The static tables as one int64 array and each one's offset in
        it, in elements: ``geom`` (L x 4: item_start, cpb, block_elems,
        numel), ``segs`` (n_segs x 2: first, count), ``seg_start`` and
        ``item_leaf`` (int32, two to an element)."""
        return _pack({
            "geom": np.stack([self.item_start, self.cpb, self.block_elems,
                              np.asarray(self.numel, np.int64)], 1),
            "segs": np.stack([self.seg_first, self.seg_count], 1),
            "seg_start": self.seg_start,
            "item_leaf": _int32_pairs(self.item_leaf)})

    def on(self, device: torch.device) -> "BlockDistDevice":
        """The tables on ``device`` for the current stream there, uploaded
        on first use: each stream has its own pointer column, so a call
        never rewrites one that a launch queued on another stream still
        reads."""
        key = _stream_key(device)
        d = self._on.get(key)
        if d is None:
            flat, off = self.packed()
            t = torch.from_numpy(flat).to(device)
            base = t.data_ptr()
            d = BlockDistDevice(
                tables=t, geom=base + 8 * off["geom"],
                segs=base + 8 * off["segs"],
                seg_start=base + 8 * off["seg_start"],
                item_leaf=base + 8 * off["item_leaf"],
                ptrs=torch.zeros((2 * self.n_leaves,), dtype=torch.int64,
                                 device=device))
            self._on[key] = d
        return d


@dataclasses.dataclass(eq=False)
class BlockDistDevice:
    """A :class:`BlockDistTable` on one device and stream: the static
    tables' addresses (into ``tables``, which this object keeps alive), and
    the pointer column (a and b base addresses per leaf) with the values it
    was last given. Calls rewrite the column only in the order of their
    stream, so it serves that one stream alone."""
    tables: torch.Tensor
    geom: int
    segs: int
    seg_start: int
    item_leaf: int
    ptrs: torch.Tensor
    last: Optional[list] = None


def block_dist_table(partition: BlockPartition,
                     chunk: int = BLOCK_DIST_CHUNK) -> BlockDistTable:
    """The grouped block_dist tables of ``partition`` (built once per
    partition for the kernel's own chunk size)."""
    if chunk == BLOCK_DIST_CHUNK:
        return per_partition(partition, "block_dist",
                             lambda: _block_dist_table(partition, chunk))
    return _block_dist_table(partition, chunk)


def _block_dist_table(partition: BlockPartition,
                      chunk: int) -> BlockDistTable:
    g = leaf_arrays(partition)
    numel = g.rows * g.row_width
    block_elems = np.where(g.n_blocks == 1, numel,
                           partition.block_rows * g.row_width)
    cpb = -(-block_elems // chunk)
    items = g.n_blocks * cpb
    item_start = np.cumsum(items) - items
    n_items = int(items.sum())
    if n_items > MAX_ITEMS:
        raise ValueError(f"{n_items} block_dist work items exceed the grid")
    item_leaf = np.repeat(np.arange(len(numel), dtype=np.int32), items)
    # one segment per (leaf, block), ordered by global block, then leaf
    seg_leaf = np.repeat(np.arange(len(numel)), g.n_blocks)
    seg_block = np.arange(int(g.n_blocks.sum())) - np.repeat(
        np.cumsum(g.n_blocks) - g.n_blocks, g.n_blocks)
    gid = g.offset[seg_leaf] + seg_block
    order = np.lexsort((seg_leaf, gid))
    seg_leaf, seg_block, gid = seg_leaf[order], seg_block[order], gid[order]
    total = partition.total_blocks
    seg_start = np.zeros((total + 1,), np.int64)
    np.cumsum(np.bincount(gid, minlength=total), out=seg_start[1:])
    return BlockDistTable(
        chunk=chunk, total_blocks=total, n_items=n_items, numel=g.numel,
        item_start=item_start, cpb=cpb,
        block_elems=block_elems, item_leaf=item_leaf, seg_start=seg_start,
        seg_first=item_start[seg_leaf] + seg_block * cpb[seg_leaf],
        seg_count=cpb[seg_leaf])


def dist_pointers(a_leaves: list, b_leaves: list,
                  table: BlockDistTable) -> tuple[list, list]:
    """The pointer column of one call: the a and b base addresses of each
    leaf, in leaf order, and the f32 copies made for leaves that are
    neither contiguous f32 nor a pair of contiguous bf16 leaves (the
    per-leaf route's ``.to(float32)``), which must stay alive until the
    launch is queued. A bf16 pair is read in place: both addresses carry
    ``BF16_FLAG`` (bit 0, free in a 2-byte aligned address). Every leaf
    must lie on the first one's device and hold its leaf's number of
    values."""
    if len(a_leaves) != table.n_leaves or len(b_leaves) != table.n_leaves:
        raise ValueError(f"need {table.n_leaves} leaves per tree, got "
                         f"{len(a_leaves)} and {len(b_leaves)}")
    dev = a_leaves[0].get_device()
    ptrs, keep = [], []
    for x, y, n in zip(a_leaves, b_leaves, table.numel):
        bf16 = all(t.dtype == torch.bfloat16 and t.is_contiguous()
                   for t in (x, y))
        for t in (x, y):
            if t.get_device() != dev or t.numel() != n:
                raise ValueError(f"a leaf of {t.numel()} values on "
                                 f"{t.device}; need {n} on "
                                 f"{a_leaves[0].device}")
            if bf16:
                ptrs.append(t.data_ptr() | BF16_FLAG)
                continue
            if t.dtype != torch.float32 or not t.is_contiguous():
                t = t.to(torch.float32).contiguous()
                keep.append(t)
            ptrs.append(t.data_ptr())
    return ptrs, keep


# ---------------------------------------------------------------------------
# scatter_save
# ---------------------------------------------------------------------------

def save_pairs(idx: np.ndarray, partition: BlockPartition
               ) -> tuple[np.ndarray, np.ndarray]:
    """The (leaf, local block) pairs that sorted unique global ids ``idx``
    select, leaf by leaf: a colocated id gives one pair per leaf that
    shares it. ``(leaf, block)`` int64 arrays."""
    g = leaf_arrays(partition)
    lo = np.searchsorted(idx, g.offset)
    count = np.searchsorted(idx, g.offset + g.n_blocks) - lo
    leaf = np.repeat(np.arange(len(count), dtype=np.int64), count)
    pos = np.arange(int(count.sum())) + np.repeat(lo - (np.cumsum(count)
                                                       - count), count)
    return leaf, idx[pos] - g.offset[leaf]


def scatter_items(block_bytes: np.ndarray, total_bytes: np.ndarray,
                  leaf: np.ndarray, block: np.ndarray,
                  chunk: int = COPY_CHUNK_BYTES
                  ) -> tuple[np.ndarray, np.ndarray]:
    """scatter_save's work for the pairs ``(leaf, block)``, given each
    leaf's block and total bytes: ``pairs`` (P x 3 int64: leaf, block,
    first item) and ``item_pair`` (int32), one item per ``chunk`` bytes of
    a pair's block, the ragged last block clamped to the leaf's bytes."""
    lo = block * block_bytes[leaf]
    length = np.clip(np.minimum(lo + block_bytes[leaf], total_bytes[leaf])
                     - lo, 0, None)
    chunks = -(-length // chunk)
    if int(chunks.sum()) > MAX_ITEMS:
        raise ValueError("scatter_save work items exceed the grid")
    first = np.cumsum(chunks) - chunks
    pairs = np.stack([leaf, block, first], 1).astype(np.int64)
    return pairs, np.repeat(np.arange(len(leaf), dtype=np.int32), chunks)


@dataclasses.dataclass(eq=False)
class ScatterTable:
    """One save's scatter_save table as one int64 array: ``leaves`` (L x
    4: dst and src base addresses, block_bytes, total_bytes; zeros where a
    leaf is untouched) at 0, ``pairs`` (P x 3) at ``pairs_at`` and
    ``item_pair`` (int32, two to an element) at ``items_at``; ``keep`` holds
    the src copies it points at."""
    table: np.ndarray
    pairs_at: int
    items_at: int
    n_items: int
    keep: list


def scatter_table(dst_leaves: list, src_leaves: list, leaf: np.ndarray,
                  block: np.ndarray, partition: BlockPartition,
                  chunk: int = COPY_CHUNK_BYTES) -> ScatterTable:
    """The table of a save of the unique pairs ``(leaf, block)`` of
    ``partition``'s leaves. Touched dst leaves must be contiguous and lie
    on one device with their src leaves, which hold as many values; a src
    leaf that is not a contiguous tensor of dst's dtype is read from such a
    copy. Raises IndexError on a block outside its leaf."""
    g = leaf_arrays(partition)
    if np.any(block < 0) or np.any(block >= g.n_blocks[leaf]):
        raise IndexError("a block id lies outside its leaf")
    touched = np.unique(leaf).tolist()
    dev = dst_leaves[touched[0]].get_device() if touched else None
    cols, keep = [], []
    for l in touched:
        d, s, n = dst_leaves[l], src_leaves[l], g.numel[l]
        dtype = d.dtype
        if s.dtype != dtype or not s.is_contiguous():
            s = s.to(dtype).contiguous()
            keep.append(s)
        if d.get_device() != dev or s.get_device() != dev \
                or not d.is_contiguous() or d.numel() != n or s.numel() != n:
            raise ValueError(
                f"leaf {partition.leaves[l].name}: dst {tuple(d.shape)} on "
                f"{d.device} (contiguous: {d.is_contiguous()}), src "
                f"{tuple(s.shape)} on {s.device}; an in-place save needs a "
                f"contiguous dst of {n} values on the first touched leaf's "
                f"device, and a src as large")
        cols += (d.data_ptr(), s.data_ptr(), dtype.itemsize)
    rows = np.zeros((len(dst_leaves), 4), np.int64)
    if touched:
        t = np.asarray(touched)
        c = np.asarray(cols, np.int64).reshape(-1, 3)
        rows[t, :2] = c[:, :2]
        rows[t, 2] = partition.block_rows * g.row_width[t] * c[:, 2]
        rows[t, 3] = g.rows[t] * g.row_width[t] * c[:, 2]
    pairs, item_pair = scatter_items(rows[:, 2], rows[:, 3], leaf, block,
                                     chunk)
    return ScatterTable(
        table=np.concatenate([rows.ravel(), pairs.ravel(),
                              _int32_pairs(item_pair)]),
        pairs_at=rows.size, items_at=rows.size + pairs.size,
        n_items=item_pair.size, keep=keep)


# ---------------------------------------------------------------------------
# masked_restore
# ---------------------------------------------------------------------------

OUT_ALIGN = 256     # bytes: each leaf's slot in a grouped restore's output


@dataclasses.dataclass(eq=False)
class RestoreTable:
    """masked_restore's grouped work over one partition whose leaves have
    the dtypes ``dtypes`` (numpy).

    Leaf ``l`` is ``total_bytes[l]`` bytes. Its block ``k`` is bytes ``[k
    * block_bytes[l], min((k + 1) * block_bytes[l], total_bytes[l]))`` of
    dst and of the output (a single-block leaf is one block of all its
    bytes), and as many bytes from ``k * pitch`` of its source, the pitch
    given per call. Work item ``g`` (one CTA) is chunk ``c`` of ``chunk``
    bytes of block ``k`` of leaf ``item_leaf[g]``, where ``g -
    item_start[l] = k * cpb[l] + c``; a ragged last block's surplus items
    copy nothing. Block ``k`` comes from the source where ``mask[mask_off[l]
    + k]``: the leaf's global block offset, so colocated leaves read the
    bits of the blocks they share. A restore of every leaf writes leaf
    ``l`` at byte ``out_off[l]`` of one ``out_bytes`` buffer, each slot
    ``OUT_ALIGN``-aligned.
    """
    chunk: int
    total_blocks: int
    n_items: int
    dtypes: tuple
    shapes: tuple
    strides: tuple           # contiguous strides of each leaf's shape
    numel: list              # per leaf, as Python ints (checked per call)
    itemsize: list
    pitch: list              # block_bytes as Python ints (a tensor's)
    item_start: np.ndarray   # int64 (L,)
    cpb: np.ndarray
    block_bytes: np.ndarray
    total_bytes: np.ndarray
    mask_off: np.ndarray
    item_leaf: np.ndarray    # int32 (n_items,)
    slot: np.ndarray         # int64 (L,) bytes of each leaf's output slot
    out_off: np.ndarray
    out_bytes: int
    _on: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def n_leaves(self) -> int:
        return len(self.numel)

    def on(self, device: torch.device) -> "RestoreDevice":
        """The static tables on ``device`` (uploaded on first use) and the
        current stream's pointer column there."""
        key = _stream_key(device)
        d = self._on.get(key)
        if d is None:
            flat, off = _pack({
                "geom": np.stack([self.item_start, self.cpb,
                                  self.block_bytes, self.total_bytes,
                                  self.mask_off], 1),
                "item_leaf": _int32_pairs(self.item_leaf)})
            t = torch.from_numpy(flat).to(device)
            d = RestoreDevice(
                tables=t, geom=t.data_ptr() + 8 * off["geom"],
                item_leaf=t.data_ptr() + 8 * off["item_leaf"],
                ptrs=torch.zeros((4 * self.n_leaves,), dtype=torch.int64,
                                 device=device))
            self._on[key] = d
        return d


@dataclasses.dataclass(eq=False)
class RestoreDevice:
    """A :class:`RestoreTable` on one device and stream: the static tables'
    addresses (into ``tables``, kept alive here) and the pointer column
    with the values it was last given."""
    tables: torch.Tensor
    geom: int
    item_leaf: int
    ptrs: torch.Tensor
    last: Optional[list] = None


def restore_table(partition: BlockPartition, dtypes: tuple,
                  chunk: int = COPY_CHUNK_BYTES) -> RestoreTable:
    """The grouped masked_restore table of ``partition`` for leaves of
    ``dtypes`` (built once per partition and dtypes for the kernel's own
    chunk size)."""
    if chunk == COPY_CHUNK_BYTES:
        return per_partition(partition, ("masked_restore", dtypes),
                             lambda: _restore_table(partition, dtypes, chunk))
    return _restore_table(partition, dtypes, chunk)


def _contiguous_strides(shape: tuple) -> tuple:
    out, step = [], 1
    for n in reversed(shape):
        out.append(step)
        step *= max(n, 1)
    return tuple(reversed(out))


def _restore_table(partition: BlockPartition, dtypes: tuple,
                   chunk: int) -> RestoreTable:
    g = leaf_arrays(partition)
    if len(dtypes) != len(g.numel):
        raise ValueError(f"need {len(g.numel)} leaf dtypes, got "
                         f"{len(dtypes)}")
    itemsize = [dt.itemsize for dt in dtypes]
    total = np.asarray(g.numel, np.int64) * np.asarray(itemsize, np.int64)
    block = np.where(g.n_blocks == 1, total,
                     partition.block_rows * g.row_width
                     * np.asarray(itemsize, np.int64))
    cpb = -(-block // chunk)
    items = g.n_blocks * cpb
    n_items = int(items.sum())
    if n_items > MAX_ITEMS:
        raise ValueError(f"{n_items} masked_restore work items exceed the "
                         f"grid")
    slot = -(-total // OUT_ALIGN) * OUT_ALIGN
    shapes = tuple(l.shape for l in partition.leaves)
    return RestoreTable(
        chunk=chunk, total_blocks=partition.total_blocks, n_items=n_items,
        dtypes=tuple(dtypes), shapes=shapes,
        strides=tuple(_contiguous_strides(s) for s in shapes),
        numel=g.numel, itemsize=itemsize, pitch=block.tolist(),
        item_start=np.cumsum(items) - items, cpb=cpb, block_bytes=block,
        total_bytes=total, mask_off=g.offset,
        item_leaf=np.repeat(np.arange(len(g.numel), dtype=np.int32), items),
        slot=slot, out_off=np.cumsum(slot) - slot, out_bytes=int(slot.sum()))


@dataclasses.dataclass(eq=False)
class RestoreCall:
    """One grouped restore: its pointer column (four int64 a leaf: dst,
    src and output base addresses, and the source's block pitch in bytes;
    zeros for a leaf left out), its output tensors (None for a leaf left
    out), and the copies the column points at, to keep alive until the
    launch is queued."""
    column: list
    out: list
    keep: list


def restore_call(dst_leaves: list, src_leaves: list, table: RestoreTable,
                 touched: Optional[np.ndarray] = None) -> RestoreCall:
    """The column and outputs of a restore of the leaves ``touched`` (every
    leaf when None). ``src_leaves[l]`` is a tensor of leaf ``l``'s values,
    read with its block pitch, or an ``(address, pitch)`` pair read in
    place (a leaf's segments in an arena). Every touched dst leaf must lie
    on the first one's device, have the table's dtype and hold its leaf's
    number of values, and so must a src tensor, which is read from a copy
    where it is not a contiguous tensor of dst's dtype (a dst that is not
    contiguous from a contiguous copy). The outputs are views of one new
    buffer, each leaf contiguous at an ``OUT_ALIGN``-aligned offset."""
    n = table.n_leaves
    if len(dst_leaves) != n or len(src_leaves) != n:
        raise ValueError(f"need {n} leaves per tree, got {len(dst_leaves)} "
                         f"and {len(src_leaves)}")
    if touched is None:
        idx, off, total = range(n), table.out_off, table.out_bytes
    else:
        idx = touched.tolist()
        slot = table.slot[touched]
        off, total = np.cumsum(slot) - slot, int(slot.sum())
    column, out, keep = [0] * (4 * n), [None] * n, []
    if not len(idx):
        return RestoreCall(column, out, keep)
    first = dst_leaves[idx[0]]
    dev = first.get_device()
    raw = torch.empty((total,), dtype=torch.uint8, device=first.device)
    base = raw.data_ptr()
    typed = {}
    for l, o in zip(idx, off.tolist()):
        d, s, nv, dt = dst_leaves[l], src_leaves[l], table.numel[l], \
            table.dtypes[l]
        if d.get_device() != dev or d.numel() != nv or d.dtype != dt:
            raise ValueError(f"dst leaf {l}: {d.numel()} values of {d.dtype} "
                             f"on {d.device}; need {nv} of {dt} on "
                             f"{first.device}")
        if not d.is_contiguous():
            d = d.contiguous()
            keep.append(d)
        if isinstance(s, tuple):
            addr, pitch = s
        else:
            if s.get_device() != dev or s.numel() != nv:
                raise ValueError(f"src leaf {l}: {s.numel()} values on "
                                 f"{s.device}; need {nv} on {first.device}")
            if s.dtype != dt or not s.is_contiguous():
                s = s.to(dt).contiguous()
                keep.append(s)
            addr, pitch = s.data_ptr(), table.pitch[l]
        v = typed.get(dt)
        if v is None:
            v = typed[dt] = raw.view(dt)
        out[l] = v.as_strided(table.shapes[l], table.strides[l],
                              o // table.itemsize[l])
        column[4 * l:4 * l + 4] = (d.data_ptr(), addr, base + o, pitch)
    return RestoreCall(column, out, keep)


# ---------------------------------------------------------------------------
# staging
# ---------------------------------------------------------------------------

def upload(values, out: torch.Tensor) -> torch.Tensor:
    """Copy int64 ``values`` (a list or an array) into ``out[:n]`` on the
    card from page-locked memory, on the current stream, without waiting:
    PyTorch's pinned-memory allocator keeps the staging buffer from reuse
    until the copy has run (it records an event behind it)."""
    host = torch.from_numpy(np.asarray(values, np.int64)).pin_memory()
    out[:host.numel()].copy_(host, non_blocking=True)
    return out
