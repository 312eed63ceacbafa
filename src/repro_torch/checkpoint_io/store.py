"""On-disk mirror of the running checkpoint (paper §4.3 persistent storage).

The port of ``repro.checkpoint_io.store``, with the reference's on-disk
format byte for byte, so that each package reads the other's store.

Layout: **packed per-shard block files**. Block payloads are appended to a
log-structured shard file (``blocks.gNNNN.shard``, or
``host_NNNN/blocks.gNNNN.shard`` under the domain keying) and
``MANIFEST.json`` carries an offset index: ``segments[seg] = [offset,
nbytes]`` points at each segment's latest copy. Appends land before the
manifest is atomically replaced, so a crash mid-write leaves unreferenced
bytes at a shard's tail, never a torn block. ``compact()`` rewrites each
shard into the next generation's file keeping only the live segments,
publishes the manifest, and only then removes the older generations.

Segments are the partition's blocks (the tree layout: each block's rows as
raw leaf-dtype bytes), or, with ``arena_layout`` at :meth:`init`, the
arena block table's rows (the arena segment layout: word payloads, raw
element bytes for word-packable dtypes and the f32 image otherwise; one
per (leaf, block)). ``MANIFEST.json`` names every dtype as numpy does
(``bfloat16``, ``float8_e4m3fn``): the port writes and reads those bytes
through uint8 and integer views, so it needs no numpy dtype for them.

**Domain keying** (``homes``/``domains`` at ``init``): one shard directory
per failure domain (the block's home host at init) and ``host_of_block``
in the manifest; :meth:`read_blocks` then touches only the needed blocks'
byte ranges, and :meth:`read_surviving` models a host-local deployment in
which a dead host's shard is unreachable. :meth:`write_parity` mirrors the
fabric's parity (one ``np.save`` file per group and ``PARITY.json``).

Writes can run on a background thread (``background=True``): "the training
algorithm can be resumed as soon as the in-memory caches have been
updated, while output to the shared persistent storage happens
asynchronously". A failed batch is retried with jittered backoff; a
failure that persists surfaces at :meth:`flush`, with its job's context.

Payloads may be CUDA tensors: the store copies them to the host in one
synchronous device-to-host copy before the file write. Reads return torch
tensors on the store's ``device`` (``cuda`` unless asked otherwise),
copying only the needed blocks' rows there. ``timings`` sums the seconds
of the device-to-host copies, the shard appends and the parity mirror.
"""
from __future__ import annotations

import copy
import json
import os
import queue
import random
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.arena import ARENA_TILE
from repro_torch.core.blocks import BlockPartition, word_packable
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.telemetry.recorder import NULL_RECORDER
from repro_torch.utils.tree import tree_leaves, tree_unflatten

PyTree = Any

# dtypes numpy names only through ml_dtypes: their bytes travel through the
# integer type of their width
_BIT_VIEWS = {torch.bfloat16: torch.int16}
for _name in ("float8_e4m3fn", "float8_e5m2", "float8_e4m3fnuz",
              "float8_e5m2fnuz", "float8_e8m0fnu"):
    if hasattr(torch, _name):
        _BIT_VIEWS[getattr(torch, _name)] = torch.int8


def dtype_name(dtype: torch.dtype) -> str:
    """The name numpy gives ``dtype`` (``str(np.dtype(...))`` in the
    reference's manifest): ``float32``, ``bfloat16``, ``bool``, ..."""
    return str(dtype).removeprefix("torch.")


def host_bytes(x: torch.Tensor) -> np.ndarray:
    """The raw little-endian bytes of ``x`` in row-major order, as a flat
    uint8 numpy array on the host."""
    x = x.detach().contiguous()
    if x.device.type != "cpu":
        x = x.cpu()
    if x.dtype in _BIT_VIEWS:
        x = x.view(_BIT_VIEWS[x.dtype])
    return x.numpy().reshape(-1).view(np.uint8)


def _from_bytes(raw: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """A CPU tensor of ``dtype`` over the bytes ``raw`` (a copy)."""
    t = torch.from_numpy(np.ascontiguousarray(raw).copy())
    return t.view(dtype)


def _shard_name(gen: int) -> str:
    return f"blocks.g{gen:04d}.shard"


def _is_shard_name(name: str) -> bool:
    return name.startswith("blocks.") and name.endswith(".shard")


class ShardedCheckpointStore:
    """``ShardedCheckpointStore(root, device=None)``: the mirror under
    ``root`` (created), read back onto ``device``."""

    # background-write retry budget: a failed batch is re-attempted this
    # many times with jittered exponential backoff (base * 2^attempt *
    # U[0.5, 1.5)) before the error is parked for flush(). Tests shrink the
    # base delay.
    _retry_limit = 2
    _retry_base_delay = 0.05

    def __init__(self, root: str, device: DeviceLike = None):
        self.root = root
        self.device = resolve_device(device)
        self.partition: Optional[BlockPartition] = None
        self.must_reload = False
        self.host_of_block: Optional[np.ndarray] = None
        self.arena_layout = None
        self._leaf_first_seg: Optional[np.ndarray] = None
        # per shard-directory compaction generation
        self._gen: dict = {}
        self._q: "queue.Queue" = queue.Queue()
        self._worker: Optional[threading.Thread] = None
        self._worker_error: Optional[BaseException] = None
        self._worker_error_ctx: Optional[dict] = None
        # one append-and-publish at a time: a synchronous write while the
        # worker drains would otherwise race it for the manifest
        self._write_lock = threading.Lock()
        self._timing_lock = threading.Lock()
        self.timings = {"d2h_seconds": 0.0, "append_seconds": 0.0,
                        "parity_d2h_seconds": 0.0,
                        "parity_write_seconds": 0.0}
        self.recorder = NULL_RECORDER
        os.makedirs(root, exist_ok=True)

    def attach_recorder(self, recorder: Any) -> None:
        """Late-bind a recorder (events only). No-op if ``recorder`` is
        null or one is already attached."""
        if recorder is None or not getattr(recorder, "enabled", False) \
                or self.recorder.enabled:
            return
        self.recorder = recorder

    def _time(self, key: str, seconds: float) -> None:
        with self._timing_lock:
            self.timings[key] += seconds

    def _to_host(self, x: torch.Tensor, key: str = "d2h_seconds"
                 ) -> np.ndarray:
        """``host_bytes`` of ``x``, its device-to-host copy timed."""
        t0 = time.perf_counter()
        out = host_bytes(x)
        if x.device.type != "cpu":
            self._time(key, time.perf_counter() - t0)
        return out

    # -- lifecycle ----------------------------------------------------------

    def init(self, params: PyTree, partition: BlockPartition,
             homes: Optional[np.ndarray] = None,
             domains: Optional[Any] = None,
             arena_layout=None,
             arena_values=None) -> None:
        """Write the manifest and the initial full mirror (x^(0)).

        ``homes``/``domains`` (a block -> device map and a
        ``FailureDomainMap``) switch on the domain-keyed layout, keyed by
        the homes at init. ``arena_layout`` with ``arena_values`` (the
        packed word arena of ``params``, a tensor) switches on the arena
        segment layout."""
        self.partition = partition
        self.arena_layout = arena_layout
        self._gen = {}
        if arena_layout is not None:
            # arena-block index of each leaf's first block: the table is
            # offset-ordered, each leaf's blocks contiguous and in order
            first = np.full((len(partition.leaves),), -1, np.int64)
            for idx, ab in enumerate(arena_layout.blocks):
                if first[ab.leaf] < 0:
                    first[ab.leaf] = idx
            self._leaf_first_seg = first
        if homes is not None and domains is not None:
            self.host_of_block = np.asarray(
                domains.host_of(np.asarray(homes)), np.int32)
            for h in np.unique(self.host_of_block):
                os.makedirs(os.path.join(self.root, f"host_{int(h):04d}"),
                            exist_ok=True)
        n_segments = (len(arena_layout.blocks) if arena_layout is not None
                      else partition.total_blocks)
        manifest = {
            "block_rows": partition.block_rows,
            "leaves": [
                {"name": l.name, "shape": list(l.shape),
                 "dtype": dtype_name(l.dtype),
                 "rows": l.rows, "row_width": l.row_width,
                 "n_blocks": l.n_blocks, "offset": l.offset}
                for l in partition.leaves
            ],
            "saved_iter": [0] * partition.total_blocks,
            "segments": [None] * n_segments,
        }
        if arena_layout is not None:
            # per-segment stored dtype: an offline reader needs no
            # partition object to decode
            seg_dtype = [
                dtype_name(partition.leaves[ab.leaf].dtype)
                if word_packable(partition.leaves[ab.leaf].dtype)
                else "float32"
                for ab in arena_layout.blocks]
            manifest["arena"] = {"n_segments": n_segments,
                                 "segment_dtype": seg_dtype}
        if self.host_of_block is not None:
            manifest["host_of_block"] = [int(h) for h in self.host_of_block]
        self._write_manifest(manifest)
        full_mask = np.ones((partition.total_blocks,), bool)
        if arena_layout is not None:
            if arena_values is None:
                raise ValueError("arena-layout init needs the packed arena "
                                 "values")
            tiles = arena_layout.tiles_for_blocks(
                np.arange(partition.total_blocks))
            self.write_arena(full_mask, tiles,
                             gather_tiles(arena_values, tiles), step=0,
                             background=False)
        else:
            self.write_blocks(full_mask, params, step=0, background=False)

    # -- arena segment helpers ----------------------------------------------

    def _seg_gid(self, seg: int) -> int:
        """Global block id owning segment ``seg``."""
        if self.arena_layout is None:
            return int(seg)
        return int(self.arena_layout.blocks[seg].gid)

    def _manifest_path(self) -> str:
        return os.path.join(self.root, "MANIFEST.json")

    def _read_manifest(self) -> dict:
        with open(self._manifest_path()) as f:
            return json.load(f)

    def _write_manifest(self, manifest: dict) -> None:
        """Atomic replace: readers see the old file or the new one."""
        tmp = self._manifest_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump(manifest, f)
        os.replace(tmp, self._manifest_path())

    def _shard_dir(self, seg: int) -> str:
        if self.host_of_block is not None:
            host = int(self.host_of_block[self._seg_gid(seg)])
            return os.path.join(self.root, f"host_{host:04d}")
        return self.root

    def _shard_path(self, seg: int) -> str:
        d = self._shard_dir(seg)
        return os.path.join(d, _shard_name(self._gen.get(d, 0)))

    # -- write path ---------------------------------------------------------

    def _submit(self, jobs: list, step: int, background: bool) -> None:
        if background:
            self._ensure_worker()
            self._q.put(("write", jobs, step))
        else:
            self._do_write(jobs, step)

    def _mirror_event(self, step: int, nbytes: int, n: int,
                      background: bool) -> None:
        if self.recorder.enabled:
            self.recorder.event("mirror", step=int(step), bytes=nbytes,
                                segments=n, background=background)

    def write_blocks(self, mask, values: PyTree, step: int,
                     background: bool = True) -> int:
        """Persist the masked blocks of the tree ``values``. Returns the
        bytes written (or scheduled)."""
        if self.partition is None:
            raise RuntimeError("call init() first")
        mask_np = np.asarray(torch.as_tensor(mask).cpu(), bool)
        leaves = tree_leaves(values)
        jobs: list[tuple[int, np.ndarray]] = []
        nbytes = 0
        br = self.partition.block_rows
        for li, (meta, x) in enumerate(zip(self.partition.leaves, leaves)):
            seg = mask_np[meta.offset:meta.offset + meta.n_blocks]
            if not seg.any():
                continue
            rows = max(meta.rows, 1)
            if self.arena_layout is not None:
                # the arena segment format from a tree: raw element bytes
                # zero-padded to the block's payload words (word-packable
                # dtypes), else one f32 word per element
                packable = word_packable(meta.dtype)
                arr = self._to_host(x if packable
                                    else x.to(torch.float32))
                row_bytes = arr.size // rows
                payload = self.arena_layout.payload_words[li] * 4
                for b in np.nonzero(seg)[0]:
                    lo = int(b) * br
                    hi = min(lo + br, rows)
                    blk = arr[lo * row_bytes:hi * row_bytes]
                    full = np.zeros((payload,), np.uint8)
                    full[:blk.size] = blk
                    jobs.append((int(self._leaf_first_seg[li]) + int(b),
                                 full))
                    nbytes += full.nbytes
            else:
                arr = self._to_host(x)
                row_bytes = arr.size // rows
                for b in np.nonzero(seg)[0]:
                    lo, hi = int(b) * br, min((int(b) + 1) * br, meta.rows)
                    if hi <= lo:
                        lo, hi = 0, 1
                    blk = arr[lo * row_bytes:hi * row_bytes]
                    jobs.append((meta.offset + int(b), blk))
                    nbytes += blk.nbytes
        self._submit(jobs, step, background)
        self._mirror_event(step, nbytes, len(jobs), background)
        return nbytes

    def write_arena(self, mask, tiles: np.ndarray, data, step: int,
                    background: bool = True) -> int:
        """Persist arena segments straight from gathered arena tiles.

        ``tiles``/``data``: the ascending tile indices covering the
        selected blocks and their ``(len(tiles), ARENA_TILE)`` words (a
        tensor on any device, or numpy; copied to the host once). Each
        selected arena block's payload is sliced out contiguously, and the
        write batches a host's payloads into one append per shard."""
        if self.arena_layout is None:
            raise RuntimeError("store not in arena mode")
        mask_np = np.asarray(torch.as_tensor(mask).cpu(), bool)
        tiles = np.asarray(tiles, np.int64)
        flat = (self._to_host(data) if isinstance(data, torch.Tensor)
                else np.ascontiguousarray(data).reshape(-1).view(np.uint8))
        flat = flat.view(np.int32)
        jobs: list[tuple[int, np.ndarray]] = []
        nbytes = 0
        for ab_index in self.arena_layout.blocks_for_gids(
                np.nonzero(mask_np)[0]):
            ab = self.arena_layout.blocks[ab_index]
            t0 = ab.offset // ARENA_TILE
            # tail-packed blocks start mid-tile and may straddle two
            # tiles, adjacent in the ascending gather
            last = (ab.offset + max(ab.words, 1) - 1) // ARENA_TILE
            nt = int(last - t0 + 1)
            pos = int(np.searchsorted(tiles, t0))
            if pos + nt > tiles.size or tiles[pos] != t0:
                raise ValueError("gathered tiles do not cover the selected "
                                 "blocks")
            start = pos * ARENA_TILE + (ab.offset - t0 * ARENA_TILE)
            payload = flat[start:start + ab.payload]
            jobs.append((int(ab_index), payload))
            nbytes += payload.nbytes
        self._submit(jobs, step, background)
        self._mirror_event(step, nbytes, len(jobs), background)
        return nbytes

    def write_parity(self, step: int, parity, parity_homes,
                     domains: Optional[Any] = None,
                     members: Optional[np.ndarray] = None) -> int:
        """Mirror the fabric's parity for offline reconstruction: one
        ``np.save`` file per group (keyed by the parity home's host when
        the store is domain-keyed) and ``PARITY.json`` (step, frame width,
        paths, homes, and each group's member block ids as of encode
        time). Synchronous. ``parity``: (n_groups, E) XOR or (n_groups, m,
        E) RS int32 words, a tensor on any device or numpy."""
        t0 = time.perf_counter()
        if isinstance(parity, torch.Tensor):
            parity = parity.detach().cpu().numpy()
            self._time("parity_d2h_seconds", time.perf_counter() - t0)
        parity = np.asarray(parity)
        t0 = time.perf_counter()
        # XOR homes are (n_groups,); RS(k, m) homes (n_groups, m), each
        # group's rows in one file keyed by row 0's host
        homes = np.asarray(parity_homes, np.int32)
        paths = []
        for g in range(parity.shape[0]):
            if self.host_of_block is not None and domains is not None:
                key = int(np.ravel(homes[g])[0]) if homes.ndim > 1 \
                    else int(homes[g])
                host_dir = f"host_{int(domains.host_of(key)):04d}"
                os.makedirs(os.path.join(self.root, host_dir), exist_ok=True)
                rel = os.path.join(host_dir, f"parity_{g:06d}.npy")
            else:
                rel = f"parity_{g:06d}.npy"
            path = os.path.join(self.root, rel)
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                np.save(f, parity[g])
            os.replace(tmp, path)
            paths.append(rel)
        meta = {"step": int(step), "n_groups": int(parity.shape[0]),
                "frame_elems": int(parity.shape[-1]) if parity.ndim > 1 else 1,
                "n_parity": int(parity.shape[1]) if parity.ndim == 3 else 1,
                "paths": paths,
                "parity_homes": homes.tolist()}
        if members is not None:
            meta["members"] = [[int(b) for b in row if b >= 0]
                               for row in np.asarray(members)]
        tmp = os.path.join(self.root, "PARITY.json.tmp")
        with open(tmp, "w") as f:
            json.dump(meta, f)
        os.replace(tmp, os.path.join(self.root, "PARITY.json"))
        self._time("parity_write_seconds", time.perf_counter() - t0)
        return int(parity.nbytes)

    def read_parity(self) -> Optional[tuple[torch.Tensor, dict]]:
        """(parity on the store's device, manifest) from the last mirror,
        or None."""
        meta_path = os.path.join(self.root, "PARITY.json")
        if not os.path.exists(meta_path):
            return None
        with open(meta_path) as f:
            meta = json.load(f)
        groups = np.stack([np.load(os.path.join(self.root, rel))
                           for rel in meta["paths"]])
        return torch.from_numpy(groups).to(self.device), meta

    # -- background writer --------------------------------------------------

    def _ensure_worker(self) -> None:
        if self._worker is None or not self._worker.is_alive():
            self._worker = threading.Thread(target=self._drain, daemon=True)
            self._worker.start()

    def _drain(self) -> None:
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                _, jobs, step = item
                self._write_with_retry(item, jobs, step)
            except BaseException as e:  # keep draining; surface on flush()
                if self._worker_error is None:
                    # keep the first failure's context: later ones are
                    # usually cascades of the same cause
                    self._worker_error = e
                    self._worker_error_ctx = self._job_context(item)
                    if self.recorder.enabled:
                        root = e
                        while root.__cause__ is not None:
                            root = root.__cause__
                        self.recorder.event("store_write_failed",
                                            error=repr(root),
                                            **self._worker_error_ctx)
            finally:
                # task_done even on failure, or flush()'s join never returns
                self._q.task_done()

    def _write_with_retry(self, item, jobs, step: int) -> None:
        for attempt in range(self._retry_limit + 1):
            try:
                self._do_write(jobs, step)
                return
            except BaseException as e:
                if attempt >= self._retry_limit:
                    raise RuntimeError(
                        f"background write failed after "
                        f"{self._retry_limit + 1} attempts") from e
                delay = (self._retry_base_delay * (2 ** attempt)
                         * (0.5 + random.random()))
                if self.recorder.enabled:
                    self.recorder.event(
                        "store_write_retried", attempt=attempt + 1,
                        delay_seconds=delay, error=repr(e),
                        **self._job_context(item))
                time.sleep(delay)

    def _job_context(self, item) -> dict:
        """step/segment/host/path of a failed background batch (its first
        job), for flush()'s error and the ``store_write_failed`` event."""
        ctx = {"step": None, "segment": None, "host": None, "path": None}
        try:
            _, jobs, step = item
            ctx["step"] = int(step)
            if jobs:
                seg = int(jobs[0][0])
                ctx["segment"] = seg
                ctx["path"] = self._shard_path(seg)
                if self.host_of_block is not None:
                    ctx["host"] = int(self.host_of_block[self._seg_gid(seg)])
        except BaseException:
            pass  # diagnostics must never mask the original failure
        return ctx

    def _do_write(self, jobs, step: int) -> None:
        """Append the segments' payloads to their shards (one write per
        shard), then publish the new offset index atomically."""
        with self._write_lock:
            self._append_and_publish(jobs, step)

    def _append_and_publish(self, jobs, step: int) -> None:
        t0 = time.perf_counter()
        by_shard: dict[str, list[tuple[int, np.ndarray]]] = {}
        for seg, blk in jobs:
            by_shard.setdefault(self._shard_path(seg), []).append((seg, blk))
        new_segments: dict[int, list[int]] = {}
        for path, batch in by_shard.items():
            with open(path, "ab") as f:
                off = f.tell()
                chunks = []
                for seg, blk in batch:
                    payload = np.ascontiguousarray(blk)
                    new_segments[seg] = [off, int(payload.nbytes)]
                    off += int(payload.nbytes)
                    chunks.append(payload.tobytes())
                f.write(b"".join(chunks))
                f.flush()
                os.fsync(f.fileno())
        manifest = self._read_manifest()
        for seg, _ in jobs:
            manifest["saved_iter"][self._seg_gid(seg)] = int(step)
            manifest["segments"][seg] = new_segments[seg]
        self._write_manifest(manifest)
        self._time("append_seconds", time.perf_counter() - t0)

    def flush(self) -> None:
        """Block until all background writes have landed. Raises if one
        failed since the last flush, naming its step, segment, host and
        shard, chained to the cause."""
        if self._worker is not None and self._worker.is_alive():
            self._q.join()
        if self._worker_error is not None:
            err, self._worker_error = self._worker_error, None
            ctx, self._worker_error_ctx = self._worker_error_ctx, None
            detail = ""
            if ctx:
                detail = (f" (step {ctx.get('step')}, "
                          f"segment {ctx.get('segment')}, "
                          f"host {ctx.get('host')}, "
                          f"shard {ctx.get('path')})")
            raise RuntimeError(
                f"background checkpoint write failed{detail}") from err

    def compact(self, rekey_homes: Optional[np.ndarray] = None,
                domains: Optional[Any] = None) -> int:
        """Rewrite every shard keeping only the live (indexed) segments;
        returns the bytes reclaimed. Synchronous (the queue is flushed
        first).

        ``rekey_homes`` (with ``domains``) re-keys the domain layout in
        the same rewrite: each live segment moves into the shard of its
        block's current home host. Crash-safe order: copy into the next
        generation's files, publish the manifest, then unlink the older
        generations."""
        if self.partition is None:
            raise RuntimeError("call init() first")
        self.flush()
        manifest = self._read_manifest()
        segments = manifest["segments"]
        # sources under the old keying, targets under the new one
        src_path = {seg: self._shard_path(seg)
                    for seg in range(len(segments))
                    if segments[seg] is not None}
        old_dirs = {self._shard_dir(seg) for seg in src_path}
        if rekey_homes is not None:
            if domains is None:
                raise ValueError("re-keying needs the domain map")
            self.host_of_block = np.asarray(
                domains.host_of(np.asarray(rekey_homes)), np.int32)
            manifest["host_of_block"] = [int(h) for h in self.host_of_block]
            for h in np.unique(self.host_of_block):
                os.makedirs(os.path.join(self.root, f"host_{int(h):04d}"),
                            exist_ok=True)
        by_dir: dict[str, list[int]] = {}
        for seg in src_path:
            by_dir.setdefault(self._shard_dir(seg), []).append(seg)

        def _size(d):
            p = os.path.join(d, _shard_name(self._gen.get(d, 0)))
            return os.path.getsize(p) if os.path.exists(p) else 0

        old_sizes = {d: _size(d) for d in old_dirs | set(by_dir)}
        mmaps: dict[str, Optional[np.memmap]] = {}
        new_size = 0
        cleanup: list[str] = []
        for d, segs in by_dir.items():
            new_gen = self._gen.get(d, 0) + 1
            new_path = os.path.join(d, _shard_name(new_gen))
            os.makedirs(d, exist_ok=True)
            with open(new_path, "wb") as f:
                # source order: a sequential read of each source shard
                for seg in sorted(segs, key=lambda s: (src_path[s],
                                                       segments[s][0])):
                    path = src_path[seg]
                    if path not in mmaps:
                        ok = os.path.exists(path) and os.path.getsize(path)
                        mmaps[path] = (np.memmap(path, np.uint8, mode="r")
                                       if ok else None)
                    mm = mmaps[path]
                    if mm is None:
                        # the source shard is gone: drop the segment (an old
                        # offset would resolve inside the new file)
                        segments[seg] = None
                        continue
                    off, n = segments[seg]
                    new_off = f.tell()
                    f.write(mm[off:off + n].tobytes())
                    segments[seg] = [new_off, n]
                f.flush()
                os.fsync(f.fileno())
            self._gen[d] = new_gen
            new_size += os.path.getsize(new_path)
            cleanup.append(d)
        mmaps.clear()
        manifest["segments"] = segments
        manifest["shard_gen"] = {os.path.relpath(d, self.root): g
                                 for d, g in self._gen.items()}
        self._write_manifest(manifest)
        keep = {os.path.join(d, _shard_name(self._gen[d])) for d in cleanup}
        for d in set(cleanup) | old_dirs:
            if not os.path.isdir(d):
                continue
            for name in os.listdir(d):
                p = os.path.join(d, name)
                if _is_shard_name(name) and p not in keep:
                    os.unlink(p)
        reclaimed = int(sum(old_sizes.values()) - new_size)
        if self.recorder.enabled:
            self.recorder.event("compact", reclaimed=reclaimed,
                                rekeyed=rekey_homes is not None)
        return reclaimed

    def disk_nbytes(self) -> dict[str, int]:
        """On-disk footprint: shard bytes (the append log), the bytes the
        index still references (live), and the parity mirror."""
        shard_bytes = 0
        parity_bytes = 0
        for dirpath, _, files in os.walk(self.root):
            for name in files:
                p = os.path.join(dirpath, name)
                if _is_shard_name(name):
                    shard_bytes += os.path.getsize(p)
                elif name.startswith("parity_") and name.endswith(".npy"):
                    parity_bytes += os.path.getsize(p)
        live = 0
        if self.partition is not None and os.path.exists(
                self._manifest_path()):
            for seg in self._read_manifest()["segments"]:
                if seg is not None:
                    live += seg[1]
        return {"shard": int(shard_bytes), "live": int(live),
                "parity": int(parity_bytes)}

    # -- read path ----------------------------------------------------------

    def _read_masked(self, block_mask: Optional[np.ndarray]) -> PyTree:
        """Reassemble from disk onto the store's device; ``block_mask=None``
        reads every block. Blocks whose shard is unreachable, never
        indexed or not asked for come back zero. Each run of consecutive
        needed blocks of a leaf is gathered on the host and copied to the
        device once."""
        if self.partition is None:
            raise RuntimeError("call init() first")
        self.flush()
        segments = self._read_manifest()["segments"]
        br = self.partition.block_rows
        mmaps: dict[str, Optional[np.memmap]] = {}

        def _payload(seg) -> Optional[np.ndarray]:
            if segments[seg] is None:
                return None
            path = self._shard_path(seg)
            if path not in mmaps:
                ok = os.path.exists(path) and os.path.getsize(path) > 0
                mmaps[path] = (np.memmap(path, np.uint8, mode="r")
                               if ok else None)
            mm = mmaps[path]
            if mm is None:
                return None
            off, n = segments[seg]
            return mm[off:off + n]

        out = []
        for li, meta in enumerate(self.partition.leaves):
            rows = max(meta.rows, 1)
            width = max(meta.row_width, 1)
            dtype = meta.dtype
            arr = torch.zeros((rows, width), dtype=dtype, device=self.device)
            packable = word_packable(dtype)
            stored = (dtype if self.arena_layout is None or packable
                      else torch.float32)
            row_bytes = width * torch.empty((), dtype=stored).element_size()
            run_lo, run = None, []

            def _flush_run():
                if run:
                    host = _from_bytes(np.concatenate(run), stored) \
                        .reshape(-1, width)
                    arr[run_lo:run_lo + host.shape[0]].copy_(
                        host.to(dtype), non_blocking=False)
                run.clear()

            for b in range(meta.n_blocks):
                gid = meta.offset + b
                if block_mask is not None and not block_mask[gid]:
                    _flush_run()
                    continue
                seg = (int(self._leaf_first_seg[li]) + b
                       if self.arena_layout is not None else gid)
                blk = _payload(seg)
                if blk is None:
                    _flush_run()
                    continue
                lo = b * br
                n_rows = (min(br, rows - lo) if meta.n_blocks > 1 else rows)
                # arena payloads carry the ragged or sub-word tail's
                # zero padding: keep the block's own rows
                blk = blk[:n_rows * row_bytes]
                if not run:
                    run_lo = lo
                run.append(blk)
            _flush_run()
            out.append(arr.reshape(meta.shape))
        return tree_unflatten(self.partition.treedef, out)

    def read_all(self) -> PyTree:
        """The full running checkpoint from disk (total-failure recovery)."""
        return self._read_masked(None)

    def read_blocks(self, block_mask) -> PyTree:
        """Partial DISK-tier read: only the masked blocks' byte ranges are
        touched, and only their rows reach the device. Off-mask blocks
        come back zero (callers select by the same mask)."""
        return self._read_masked(np.asarray(
            torch.as_tensor(block_mask).cpu(), bool))

    def read_surviving(self, failed_hosts) -> tuple[PyTree, np.ndarray]:
        """Host-local-deployment read: blocks whose shard sits on a failed
        host are unreadable. Returns (values, present_mask): missing blocks
        are zero in ``values`` and False in the mask."""
        if self.partition is None:
            raise RuntimeError("call init() first")
        if self.host_of_block is None:
            present = np.ones((self.partition.total_blocks,), bool)
            return self.read_all(), present
        failed = np.asarray(failed_hosts, np.int32)
        present = ~np.isin(self.host_of_block, failed)
        return self._read_masked(present), present

    def reader(self, device: DeviceLike) -> "ShardedCheckpointStore":
        """A handle on the same files that reads onto ``device`` (the
        layout, keying and generations of this store; pending writes are
        flushed first). For reading only."""
        self.flush()
        out = copy.copy(self)
        out.device = resolve_device(device)
        out._q = queue.Queue()
        out._worker = None
        out._write_lock = threading.Lock()
        out._timing_lock = threading.Lock()
        out.timings = dict.fromkeys(self.timings, 0.0)
        return out

    def saved_iters(self) -> np.ndarray:
        return np.asarray(self._read_manifest()["saved_iter"], np.int32)


def gather_tiles(arena: torch.Tensor, tiles: np.ndarray) -> torch.Tensor:
    """The ``(len(tiles), ARENA_TILE)`` words of ``arena`` at ``tiles``
    (ascending), on the arena's device: a view when the tiles are the
    whole arena, else one gather."""
    view = arena.reshape(-1, ARENA_TILE)
    tiles = np.asarray(tiles, np.int64)
    if tiles.size == view.shape[0] and (
            tiles.size == 0 or (tiles[0] == 0 and tiles[-1] == tiles.size - 1)):
        return view
    return view[torch.from_numpy(tiles).to(arena.device)]
