"""The collectives of the sharded arena, over one mesh's process group.

:class:`MeshComm` binds a :class:`~repro_torch.launch.mesh.Mesh` to this
rank's position and provides what the meshed trainer and fabric move
between ranks:

- ``slice_gather``: the words of this rank's model slices of one group
  (``sharding.partition.SlicePlan``: a layer, or the outer group) from
  every owner's span -> the group's slice-domain buffer (the train
  step's operands, a layer's gathered as it runs), one all-to-all;
- ``slice_reduce``: this rank's slice-domain gradient of one group -> the
  owners of its words, the group's words of each owner's span the sum of
  what it receives, added on the device in position order (one
  all-to-all);
- ``all_gather``: every rank's span -> the whole arena (the PyTree
  step's reduced gradient, the fabric's checks);
- ``reduce_scatter``: a whole buffer -> this rank's span of the sum (an
  all-to-all of the spans, then the sum on the device in position
  order);
- ``all_to_all``: variable-size chunks to every rank (the XOR combine's
  partial parity tiles, sent to the rank that owns their rows);
- ``ship``: this rank's span to the rank ``shift`` positions on, and the
  span of the rank ``shift`` positions back (the anti-affine replica);
- ``all_reduce`` (sum), ``broadcast`` and ``gather`` (scores, losses,
  the initial weights, the tiers at the first rank for a check);

and :func:`respan` moves a sharded buffer from one mesh to another (the
elastic resize).

:class:`CountingComm` stands in for :class:`MeshComm` on a dry mesh
(``launch.mesh.DryMesh``, the dry run's): it sends nothing, returns
tensors of the shapes and dtypes the real collective returns, and books
each call in :data:`STATS` as :class:`MeshComm` would and in
:data:`DRY_STATS` under the reference's HLO kinds (a mesh's ``comm()``
gives one of the two).

The tensor-parallel forward's collectives run over one line of the mesh's
``model`` axis (:class:`ModelAxis`, :func:`model_axis`), as
``torch.autograd.Function`` objects: ``copy`` (forward identity, backward the
gradient summed over the line; booked as ``copy_to_model``), ``reduce``
(forward the partials summed, backward identity: ``reduce_from_model``,
or ``moe_reduce_scatter`` and ``moe_all_gather`` on the MoE's
reduce-scatter route) and the forward-only ``maxed`` (``model_max``).
Their sums add the positions' tensors in position order after one
all-gather (:meth:`MeshComm.summed`), the order the reduce-scatter adds
in, so the two routes of the MoE combine give the same bits. Serving on a
mesh adds the tokens' all-gather over the data line (:func:`data_comm`,
``serve_tokens``) and a sampled token's broadcast over the model line
(``serve_sample``).

Each call is counted in :data:`STATS` under its name: ``calls``,
``bytes`` (what crosses between ranks for this rank: an all-gather's
received spans, a reduce-scatter's sent and received parts, an
all-to-all's, a slice gather's and a slice reduce's sent and received
words, a ship's span, a gather's spans at the first rank, the tensor of
an all-reduce or a broadcast), ``seconds``
(wall time of the call, its staging included) and ``staged_bytes``; the
slice gather and reduce add ``result_bytes``, their result's (the rank's
slices; its span).

**Staging.** gloo takes CUDA tensors for ``broadcast`` and
``all_reduce`` only, and NCCL refuses two ranks on one device, so the
ranks sharing one card run gloo over host memory: with the gloo backend
every CUDA tensor goes through page-locked host buffers, copied down
before the backend's call and up after it, and ``staged_bytes`` counts
both copies. A collective runs in pieces of at most ``CHUNK_BYTES`` a rank
(the same pieces on every rank), so the host buffers stay that small:
whole-arena buffers staged at once took four ranks past the 96 GiB of
host memory of the card's machine. On the CPU, and with NCCL, tensors go
to the backend as they are (in the same pieces). A one-rank mesh (or no
process group) makes no backend call: each collective is then a copy, bit
for bit what the backend would return.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.core.arena import span_overlaps

CHUNK_BYTES = 1 << 26
# pieces a collective keeps in flight: gloo runs a group's calls on two
# threads, so two pieces overlap one's transfer with the other's staging
IN_FLIGHT = 2
STATS: dict[str, dict] = {}


def reset_stats() -> None:
    STATS.clear()


def seconds_and_bytes() -> dict:
    """:data:`STATS` as plain numbers (for a report)."""
    return {k: dict(v) for k, v in sorted(STATS.items())}


def _book(name: str, nbytes: int, seconds: float, staged: int,
          result: Optional[int] = None) -> None:
    s = STATS.setdefault(name, {"calls": 0, "bytes": 0, "seconds": 0.0,
                                "staged_bytes": 0})
    s["calls"] += 1
    s["bytes"] += int(nbytes)
    s["seconds"] += seconds
    s["staged_bytes"] += int(staged)
    if result is not None:
        s["result_bytes"] = s.get("result_bytes", 0) + int(result)


def _send_boxes(src: torch.Tensor, lists: list, origin: Optional[int]
                ) -> torch.Tensor:
    """The words of ``src`` that each list of boxes names, back to back in
    list order and box order: arena-side views of a span whose element 0
    is arena word ``origin``, or slice-side views (``origin`` None)."""
    total = sum(b.numel for bx in lists for b in bx)
    out = torch.empty((total,), dtype=src.dtype, device=src.device)
    at = 0
    for bx in lists:
        for b in bx:
            k = b.numel
            out[at:at + k].view(b.sizes).copy_(
                b.slice_view(src) if origin is None
                else b.arena_view(src, origin))
            at += k
    return out


def _pieces(m: int, item: int) -> list[tuple[int, int]]:
    """``[0, m)`` in pieces of at most ``CHUNK_BYTES``."""
    step = max(1, CHUNK_BYTES // item)
    return [(a, min(a + step, m)) for a in range(0, m, step)]


def _pipelined(pieces: list, start, finish) -> None:
    """Run ``start(i, a, b)`` (which starts piece ``i``'s backend call and
    returns its handle) for every piece with ``IN_FLIGHT`` calls at most
    outstanding, and ``finish(handle)`` for each, in order. Piece ``i``
    uses staging slot ``i % IN_FLIGHT``."""
    pending = []
    for i, (a, b) in enumerate(pieces):
        pending.append(start(i, a, b))
        if len(pending) == IN_FLIGHT:
            finish(pending.pop(0))
    for h in pending:
        finish(h)


class _Stage:
    """Page-locked host buffers, one per use and kept, and the count of
    bytes copied through them."""

    def __init__(self):
        self._bufs: dict[tuple, torch.Tensor] = {}
        self.bytes = 0

    def buf(self, key: str, numel: int, dtype) -> torch.Tensor:
        b = self._bufs.get((key, dtype))
        if b is None or b.numel() < numel:
            b = torch.empty((numel,), dtype=dtype, pin_memory=True)
            self._bufs[(key, dtype)] = b
        return b[:numel]

    def down(self, key: str, t: torch.Tensor) -> torch.Tensor:
        """A host copy of ``t`` (flat)."""
        h = self.buf(key, t.numel(), t.dtype)
        h.view(t.shape).copy_(t)
        self.bytes += t.numel() * t.element_size()
        return h

    def up(self, dst: torch.Tensor, src: torch.Tensor) -> None:
        dst.copy_(src.view(dst.shape))
        self.bytes += dst.numel() * dst.element_size()


class MeshComm:
    """Collectives of ``mesh`` for this rank (a member)."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.n = mesh.size
        pos = mesh.position()
        if pos is None:
            raise ValueError(f"this rank is not in {mesh}")
        self.pos = pos
        self.group = mesh.group
        self.ranks = mesh.ranks
        self.distributed = self.n > 1
        self.gloo = self.distributed and dist.get_backend(self.group) \
            == "gloo"
        self._stage = _Stage()

    @property
    def is_root(self) -> bool:
        return self.pos == 0

    def _staged(self, t: torch.Tensor) -> bool:
        return self.gloo and t.is_cuda

    def _into(self, key: str, like: torch.Tensor, numel: int) -> torch.Tensor:
        """A flat buffer for the backend to write ``numel`` elements of
        ``like``'s dtype: host memory when staged."""
        if self._staged(like):
            return self._stage.buf(key, numel, like.dtype)
        return torch.empty((numel,), dtype=like.dtype, device=like.device)

    def _from(self, key: str, t: torch.Tensor) -> torch.Tensor:
        """``t`` (flat, contiguous) as the backend takes it."""
        if self._staged(t):
            return self._stage.down(key, t)
        return t.contiguous().view(-1)

    def _land(self, dst: torch.Tensor, src: torch.Tensor) -> None:
        if self._staged(dst):
            self._stage.up(dst, src)
        else:
            dst.copy_(src.view(dst.shape))

    def _done(self, name: str, nbytes: int, t0: float, s0: int,
              result: Optional[int] = None) -> None:
        _book(name, nbytes, time.perf_counter() - t0,
              self._stage.bytes - s0, result)

    # -- collectives -----------------------------------------------------

    def all_gather(self, span: torch.Tensor,
                   out: Optional[torch.Tensor] = None,
                   name: str = "all_gather") -> torch.Tensor:
        """The spans of every position, concatenated in position order."""
        t0, s0 = time.perf_counter(), self._stage.bytes
        n, m = self.n, span.numel()
        if out is None:
            out = torch.empty((n * m,), dtype=span.dtype, device=span.device)
        if not self.distributed:
            out.copy_(span.reshape(-1))
            self._done(name, 0, t0, s0)
            return out
        src_all, outv = span.reshape(-1), out.view(n, m)

        def start(i, a, b):
            src = self._from(f"ag_in{i % IN_FLIGHT}", src_all[a:b])
            dst = self._into(f"ag_out{i % IN_FLIGHT}", span, n * (b - a))
            with warnings.catch_warnings():
                # renamed all_gather_single in newer releases
                warnings.simplefilter("ignore", FutureWarning)
                work = dist.all_gather_into_tensor(dst, src, group=self.group,
                                                   async_op=True)
            return work, dst, a, b

        def finish(h):
            work, dst, a, b = h
            work.wait()
            self._land(outv[:, a:b], dst.view(n, b - a))
        _pipelined(_pieces(m, span.element_size()), start, finish)
        self._done(name, (n - 1) * m * span.element_size(), t0, s0)
        return out

    def reduce_scatter(self, full: torch.Tensor,
                       out: Optional[torch.Tensor] = None,
                       name: str = "reduce_scatter") -> torch.Tensor:
        """This position's span of the sum of every rank's ``full``: an
        all-to-all sends span ``k`` of ``full`` to position ``k``, and the
        n parts a position receives are added on its device in position
        order (the same order on every rank and run). gloo's own
        reduce-scatter moved twice the bytes in the card's runs."""
        t0, s0 = time.perf_counter(), self._stage.bytes
        n = self.n
        m = full.numel() // n
        if full.numel() != n * m:
            raise ValueError(f"{full.numel()} values do not split {n} ways")
        if out is None:
            out = torch.empty((m,), dtype=full.dtype, device=full.device)
        if not self.distributed:
            out.copy_(full.reshape(-1))
            self._done(name, 0, t0, s0)
            return out
        fv = full.reshape(n, m)

        def start(i, a, b):
            src = self._from(f"rs_in{i % IN_FLIGHT}", fv[:, a:b])
            dst = self._into(f"rs_out{i % IN_FLIGHT}", full, n * (b - a))
            work = dist.all_to_all_single(dst, src, group=self.group,
                                          async_op=True)
            return work, dst, a, b

        def finish(h):
            work, dst, a, b = h
            work.wait()
            parts = torch.empty((n, b - a), dtype=full.dtype,
                                device=full.device)
            self._land(parts, dst.view(n, b - a))
            acc = out[a:b]
            acc.copy_(parts[0])
            for k in range(1, n):
                acc.add_(parts[k])
        _pipelined(_pieces(m, full.element_size()), start, finish)
        self._done(name, 2 * (n - 1) * m * full.element_size(), t0, s0)
        return out

    def _slice_counts(self, plan, reduce: bool, group: int
                      ) -> tuple[list, list]:
        """Words this rank sends each position and receives from each in
        ``plan``'s gather (or reduce) of ``group``, none to or from
        itself."""
        me, m, n = self.pos, plan.model, self.n
        if reduce:
            sc = [plan.reduce_words(q, m, group) for q in range(n)]
            rc = [plan.reduce_words(me, plan.model_of[p], group)
                  for p in range(n)]
        else:
            sc = [plan.gather_words(me, plan.model_of[p], group)
                  for p in range(n)]
            rc = [plan.gather_words(q, m, group) for q in range(n)]
        sc[me] = rc[me] = 0
        return sc, rc

    def slice_gather(self, span: torch.Tensor, plan, group: int,
                     name: str = "slice_gather") -> torch.Tensor:
        """This rank's slices (``plan``, a
        :class:`~repro_torch.sharding.partition.SlicePlan`; of its
        ``group``) of the arena whose span this rank
        holds, as a new slice-domain buffer of ``span``'s dtype: each
        owner sends each position the words of its span that the
        position's slices cover, in one all-to-all (in rounds), and the
        received words land in their boxes."""
        t0, s0 = time.perf_counter(), self._stage.bytes
        me, m = self.pos, plan.model
        w0 = me * plan.shard_words
        out = torch.empty((plan.group_values(group, m),), dtype=span.dtype,
                          device=span.device)
        for b in plan.gather_boxes(me, m, group):
            b.slice_view(out).copy_(b.arena_view(span, w0))
        item = span.element_size()
        if not self.distributed:
            self._done(name, 0, t0, s0, out.numel() * item)
            return out
        sc, rc = self._slice_counts(plan, False, group)
        send = _send_boxes(span, [plan.gather_boxes(me, plan.model_of[p],
                                                    group)
                                  if p != me else [] for p in range(self.n)],
                           w0)
        recv = torch.empty((sum(rc),), dtype=span.dtype, device=span.device)
        _rounds(send, sc, recv, rc, plan.max_count(False, group),
                self.group, self._staged(send), self._stage)
        del send
        at = 0
        for q in range(self.n):
            for b in plan.gather_boxes(q, m, group) if q != me else ():
                k = b.numel
                b.slice_view(out).copy_(recv[at:at + k].view(b.sizes))
                at += k
        self._done(name, (sum(sc) + sum(rc)) * item, t0, s0,
                   out.numel() * item)
        return out

    def slice_reduce(self, values: torch.Tensor, plan, group: int,
                     out: Optional[torch.Tensor] = None,
                     name: str = "slice_reduce") -> torch.Tensor:
        """This rank's span of the sum of every rank's slice-domain
        ``values`` (``plan``; of its ``group``): each
        rank sends each owner its values on the words of the owner's span
        it contributes to
        (:meth:`~repro_torch.sharding.partition.SlicePlan.reduce_boxes`),
        and the owner adds what it receives on its device in position
        order, the order :meth:`reduce_scatter` adds in (the first
        position's part copied, the others added), skipping the positions
        that contribute nothing. Written into the group's words of
        ``out``, a span of zeros where none is given (a word no position
        contributes to, a pad, keeps its value), and returned."""
        t0, s0 = time.perf_counter(), self._stage.bytes
        me, m = self.pos, plan.model
        w0 = me * plan.shard_words
        if out is None:
            out = torch.zeros((plan.shard_words,), dtype=values.dtype,
                              device=values.device)
        item = values.element_size()
        sc, rc = self._slice_counts(plan, True, group)
        recv = None
        if self.distributed:
            send = _send_boxes(values, [plan.reduce_boxes(q, m, group)
                                        if q != me else []
                                        for q in range(self.n)], None)
            recv = torch.empty((sum(rc),), dtype=values.dtype,
                               device=values.device)
            _rounds(send, sc, recv, rc, plan.max_count(True, group),
                    self.group, self._staged(send), self._stage)
            del send
        at = 0
        for p in range(self.n):
            for b in plan.reduce_boxes(me, plan.model_of[p], group):
                if p == me:
                    part = b.slice_view(values)
                else:
                    part = recv[at:at + b.numel].view(b.sizes)
                    at += b.numel
                dst = b.arena_view(out, w0)
                if p == 0:
                    dst.copy_(part)
                else:
                    dst.add_(part)
        self._done(name, (sum(sc) + sum(rc)) * item, t0, s0,
                   plan.owned_words(me, group) * item)
        return out

    def all_reduce(self, t: torch.Tensor, name: str = "all_reduce"
                   ) -> torch.Tensor:
        """Sum over the mesh, in place (small tensors: scores, losses)."""
        if self.distributed:
            t0, s0 = time.perf_counter(), self._stage.bytes
            buf = self._from("ar", t)
            dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=self.group)
            if buf.data_ptr() != t.data_ptr():
                self._land(t, buf)
            self._done(name, t.numel() * t.element_size(), t0, s0)
        return t

    def summed(self, t: torch.Tensor, name: str,
               dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """The sum over the positions of ``t`` (every position's of one
        shape), a new tensor in ``dtype`` (default ``t``'s): the
        positions' tensors all-gathered in ``t``'s dtype and added in
        ``dtype`` on this rank's device in position order, the order
        :meth:`reduce_scatter` adds its parts in, so a reduce-scatter and
        all-gather of the same tensors gives the same bits for any number
        of positions. Gathering bf16 partials and adding them in f32 gives
        the bits of gathering them cast to f32, at half the bytes."""
        dtype = dtype or t.dtype
        if not self.distributed:
            self._done(name, 0, time.perf_counter(), self._stage.bytes)
            return t.to(dtype, copy=True)
        parts = self.all_gather(t, name=name).view((self.n,) + t.shape)
        acc = parts[0].to(dtype, copy=True)
        for k in range(1, self.n):
            acc.add_(parts[k])
        return acc

    def maxed(self, t: torch.Tensor, name: str) -> torch.Tensor:
        """The elementwise maximum over the positions of ``t``."""
        if not self.distributed:
            self._done(name, 0, time.perf_counter(), self._stage.bytes)
            return t.clone()
        parts = self.all_gather(t, name=name).view((self.n,) + t.shape)
        return torch.amax(parts, dim=0)

    def broadcast(self, t: torch.Tensor, root: int = 0,
                  name: str = "broadcast") -> torch.Tensor:
        """``t`` of position ``root`` on every position, in place."""
        if not self.distributed:
            return t
        t0, s0 = time.perf_counter(), self._stage.bytes
        flat = t.view(-1)
        for a, b in _pieces(flat.numel(), t.element_size()):
            buf = self._from("bc", flat[a:b])
            dist.broadcast(buf, src=self.ranks[root], group=self.group)
            if buf.data_ptr() != flat[a:b].data_ptr():
                self._land(flat[a:b], buf)
        self._done(name, t.numel() * t.element_size(), t0, s0)
        return t

    def all_to_all(self, send: torch.Tensor, send_counts, recv_counts,
                   max_count: int) -> torch.Tensor:
        """1-D ``send`` cut into ``send_counts[k]`` elements for position
        ``k`` (in position order); returns the chunks received,
        ``recv_counts[k]`` from position ``k``, in position order.
        ``max_count`` is the largest count between any two positions (the
        same on every rank: it sets the number of rounds)."""
        t0, s0 = time.perf_counter(), self._stage.bytes
        sc = [int(c) for c in send_counts]
        rc = [int(c) for c in recv_counts]
        out = torch.empty((sum(rc),), dtype=send.dtype, device=send.device)
        if not self.distributed:
            out.copy_(send)
            self._done("all_to_all", 0, t0, s0)
            return out
        _rounds(send, sc, out, rc, max_count, self.group, self._staged(send),
                self._stage)
        item = send.element_size()
        crossed = (sum(sc) - sc[self.pos] + sum(rc) - rc[self.pos]) * item
        self._done("all_to_all", crossed, t0, s0)
        return out

    def ship(self, span: torch.Tensor, shift: int) -> torch.Tensor:
        """Send ``span`` to position ``pos + shift`` and return the span of
        position ``pos - shift`` (mod n)."""
        t0, s0 = time.perf_counter(), self._stage.bytes
        shift %= self.n
        out = torch.empty_like(span)
        if shift == 0:
            out.copy_(span)
            self._done("ship", 0, t0, s0)
            return out
        to = self.ranks[(self.pos + shift) % self.n]
        frm = self.ranks[(self.pos - shift) % self.n]
        src_all, out_all = span.view(-1), out.view(-1)

        def start(i, a, b):
            src = self._from(f"ship_in{i % IN_FLIGHT}", src_all[a:b])
            dst = self._into(f"ship_out{i % IN_FLIGHT}", span, b - a)
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, src, to, self.group),
                dist.P2POp(dist.irecv, dst, frm, self.group)])
            return reqs, dst, a, b

        def finish(h):
            reqs, dst, a, b = h
            for r in reqs:
                r.wait()
            self._land(out_all[a:b], dst)
        _pipelined(_pieces(span.numel(), span.element_size()), start,
                   finish)
        self._done("ship", span.numel() * span.element_size(), t0, s0)
        return out

    def gather(self, span: torch.Tensor, root: int = 0,
               slots: Optional[list] = None) -> Optional[torch.Tensor]:
        """Every position's span concatenated at position ``root`` (None
        elsewhere): position ``p``'s at slot ``slots[p]`` (default ``p``)."""
        t0, s0 = time.perf_counter(), self._stage.bytes
        n, m = self.n, span.numel()
        if not self.distributed:
            out = span.reshape(-1).clone()
            self._done("gather", 0, t0, s0)
            return out
        mine = self.pos == root
        out = (torch.empty((n * m,), dtype=span.dtype, device=span.device)
               if mine else None)
        src_all = span.reshape(-1)
        for a, b in _pieces(m, span.element_size()):
            src = self._from("g_in", src_all[a:b])
            parts = None
            if mine:
                dst = self._into("g_out", span, n * (b - a))
                parts = list(dst.view(n, b - a).unbind(0))
            dist.gather(src, parts, dst=self.ranks[root], group=self.group)
            if mine:
                got = dst.view(n, b - a)
                for p in range(n):
                    q = p if slots is None else slots[p]
                    self._land(out.view(n, m)[q, a:b], got[p])
        item = span.element_size()
        self._done("gather", (n - 1) * m * item if mine else m * item, t0,
                   s0)
        return out


def _rounds(send: torch.Tensor, sc: list, out: torch.Tensor, rc: list,
            max_count: int, group, staged: bool, stage: _Stage) -> None:
    """An all-to-all (counts ``sc`` out, ``rc`` in, in the rank order of
    ``group``) in rounds of at most ``CHUNK_BYTES`` a pair; every rank
    runs ``ceil(max_count / chunk)`` rounds."""
    item = send.element_size()
    step = max(1, CHUNK_BYTES // item)
    s_off = [sum(sc[:k]) for k in range(len(sc))]
    r_off = [sum(rc[:k]) for k in range(len(rc))]
    for i in range(-(-max(int(max_count), 0) // step)):
        lo = i * step
        s_i = [max(0, min(c - lo, step)) for c in sc]
        r_i = [max(0, min(c - lo, step)) for c in rc]
        parts = [send[s_off[k] + lo:s_off[k] + lo + s_i[k]]
                 for k in range(len(sc)) if s_i[k]]
        chunk = torch.cat(parts) if parts else send[:0]
        if staged:
            src = stage.down("a2a_in", chunk)
            dst = stage.buf("a2a_out", sum(r_i), send.dtype)
        else:
            src = chunk.contiguous()
            dst = torch.empty((sum(r_i),), dtype=send.dtype,
                              device=send.device)
        dist.all_to_all_single(dst, src, r_i, s_i, group=group)
        at = 0
        for k, c in enumerate(r_i):
            if c:
                piece = out[r_off[k] + lo:r_off[k] + lo + c]
                if staged:
                    stage.up(piece, dst[at:at + c])
                else:
                    piece.copy_(dst[at:at + c])
                at += c


# the reference's collective kinds (``repro.launch.dryrun._COLLECTIVES``)
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")
DRY_STATS: dict[str, dict] = {}


def reset_dry_stats() -> None:
    DRY_STATS.clear()
    DRY_STATS.update({k: {"count": 0, "bytes": 0} for k in KINDS})


def dry_stats() -> dict:
    """:data:`DRY_STATS` with ``total_bytes``, the reference's
    ``collective_stats`` record."""
    if not DRY_STATS:
        reset_dry_stats()
    out = {k: dict(v) for k, v in DRY_STATS.items()}
    out["total_bytes"] = sum(v["bytes"] for v in DRY_STATS.values())
    return out


def _dry_book(kind: str, result: torch.Tensor) -> None:
    if not DRY_STATS:
        reset_dry_stats()
    DRY_STATS[kind]["count"] += 1
    DRY_STATS[kind]["bytes"] += result.numel() * result.element_size()


class CountingComm:
    """:class:`MeshComm`'s stand-in for a line of ``mesh.size`` ranks of a
    dry mesh (``launch.mesh.DryMesh``), at its live position: every method
    the train and serve steps call, none of which sends anything. Each
    returns a tensor of the real collective's shape and dtype on the
    input's device (a new one, its values unset: its own part copied in
    where the real one holds it, ``all_gather`` and ``reduce_scatter``;
    the whole result landed in one copy from an unset value,
    ``slice_gather`` and ``slice_reduce``, whose own parts vary with the
    span's place and not with the depth, and whose send and receive
    buffers are not made; the input's values for
    ``summed``, ``maxed``, ``all_reduce`` and ``broadcast``), and books
    the call twice: in :data:`STATS` under its name with the bytes
    :class:`MeshComm` counts for this rank (calls and bytes the same as a
    real mesh's rank; no seconds), and in :data:`DRY_STATS` under the
    reference's HLO kind with the result's bytes, as the reference's
    ``collective_stats`` reads its compiled collectives' result shapes.
    The kinds: ``all_gather`` and ``slice_gather`` (the rank's slices of
    a group) an all-gather; ``reduce_scatter`` and ``slice_reduce`` a
    reduce-scatter (its result the span; a group's, the words of the span
    its leaves hold, landed at the span's head: their place varies with
    the span's and not with the depth); ``summed``,
    ``maxed`` and ``all_reduce`` an all-reduce of the result's shape (the
    port runs the first two as an all-gather and a sum on the rank);
    ``broadcast`` a collective-permute of the tensor; ``all_to_all`` an
    all-to-all of the chunks received."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.n = mesh.size
        self.pos = mesh.position()
        self.distributed = self.n > 1

    def all_gather(self, span: torch.Tensor,
                   out: Optional[torch.Tensor] = None,
                   name: str = "all_gather") -> torch.Tensor:
        n, m = self.n, span.numel()
        if out is None:
            out = torch.empty((n * m,), dtype=span.dtype, device=span.device)
        out.view(n, m)[self.pos].copy_(span.reshape(-1))
        _book(name, (n - 1) * m * span.element_size() if n > 1 else 0,
              0.0, 0)
        _dry_book("all-gather", out)
        return out

    def reduce_scatter(self, full: torch.Tensor,
                       out: Optional[torch.Tensor] = None,
                       name: str = "reduce_scatter") -> torch.Tensor:
        n = self.n
        m = full.numel() // n
        if full.numel() != n * m:
            raise ValueError(f"{full.numel()} values do not split {n} ways")
        if out is None:
            out = torch.empty((m,), dtype=full.dtype, device=full.device)
        out.copy_(full.reshape(n, m)[self.pos])
        _book(name, 2 * (n - 1) * m * full.element_size() if n > 1 else 0,
              0.0, 0)
        _dry_book("reduce-scatter", out)
        return out

    def all_reduce(self, t: torch.Tensor, name: str = "all_reduce"
                   ) -> torch.Tensor:
        if self.distributed:
            _book(name, t.numel() * t.element_size(), 0.0, 0)
            _dry_book("all-reduce", t)
        return t

    def summed(self, t: torch.Tensor, name: str,
               dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        out = t.to(dtype or t.dtype, copy=True)
        _book(name, (self.n - 1) * t.numel() * t.element_size()
              if self.distributed else 0, 0.0, 0)
        if self.distributed:
            _dry_book("all-reduce", out)
        return out

    def maxed(self, t: torch.Tensor, name: str) -> torch.Tensor:
        out = t.clone()
        _book(name, (self.n - 1) * t.numel() * t.element_size()
              if self.distributed else 0, 0.0, 0)
        if self.distributed:
            _dry_book("all-reduce", out)
        return out

    def broadcast(self, t: torch.Tensor, root: int = 0,
                  name: str = "broadcast") -> torch.Tensor:
        if self.distributed:
            _book(name, t.numel() * t.element_size(), 0.0, 0)
            _dry_book("collective-permute", t)
        return t

    def all_to_all(self, send: torch.Tensor, send_counts, recv_counts,
                   max_count: int) -> torch.Tensor:
        sc = [int(c) for c in send_counts]
        rc = [int(c) for c in recv_counts]
        out = torch.empty((sum(rc),), dtype=send.dtype, device=send.device)
        item = send.element_size()
        _book("all_to_all", (sum(sc) - sc[self.pos] + sum(rc) - rc[self.pos])
              * item if self.distributed else 0, 0.0, 0)
        _dry_book("all-to-all", out)
        return out

    _slice_counts = MeshComm._slice_counts

    def _landed(self, numel: int, like: torch.Tensor) -> torch.Tensor:
        """A result of ``numel`` values landed from a received buffer, both
        unset: one copy, as the real rank's landing of every word."""
        out = torch.empty((numel,), dtype=like.dtype, device=like.device)
        return out.copy_(torch.empty_like(out))

    def slice_gather(self, span: torch.Tensor, plan, group: int,
                     name: str = "slice_gather") -> torch.Tensor:
        out = self._landed(plan.group_values(group), span)
        sc, rc = self._slice_counts(plan, False, group)
        item = span.element_size()
        _book(name, (sum(sc) + sum(rc)) * item, 0.0, 0, out.numel() * item)
        _dry_book("all-gather", out)
        return out

    def slice_reduce(self, values: torch.Tensor, plan, group: int,
                     out: Optional[torch.Tensor] = None,
                     name: str = "slice_reduce") -> torch.Tensor:
        if out is None:
            out = torch.empty((plan.shard_words,), dtype=values.dtype,
                              device=values.device)
        # the group's words of the span landed in one copy from an unset
        # value (the first of them: their place varies with the span's)
        k = plan.owned_words(self.pos, group)
        landed = out.narrow(0, 0, k)
        landed.copy_(values.new_empty(()).expand(k))
        sc, rc = self._slice_counts(plan, True, group)
        item = values.element_size()
        _book(name, (sum(sc) + sum(rc)) * item, 0.0, 0, k * item)
        _dry_book("reduce-scatter", landed)
        return out


def respan(span: Optional[torch.Tensor], old_ranks: list, old_size: int,
           new_ranks: list, new_size: int, data: int, dtype,
           device) -> Optional[torch.Tensor]:
    """Move a flat-sharded buffer from one mesh to another: the ranks
    ``old_ranks`` (ascending, in position order) hold ``old_size``
    elements each, the ranks ``new_ranks`` are to hold ``new_size`` each;
    elements at or past ``data`` (the shard pad) are zero and not sent.
    Every rank of the default group calls it (members of neither mesh
    too): one all-to-all over the default group (in rounds) sends each old
    span's overlap with each new span to that span's rank, so the buffer
    crosses once. ``span`` is this rank's old span (None when it is not an
    old member); returns its new span (None when it is not a new member).
    Staged through host memory under gloo as :class:`MeshComm` stages."""
    t0 = time.perf_counter()
    if list(old_ranks) != sorted(old_ranks) \
            or list(new_ranks) != sorted(new_ranks):
        raise ValueError("mesh ranks must ascend in position order")
    me = dist.get_rank() if dist.is_initialized() else 0
    world = dist.get_world_size() if dist.is_initialized() else 1
    sc, rc, pieces = [0] * world, [0] * world, []
    for p, q, lo, hi in span_overlaps(len(old_ranks), old_size,
                                      len(new_ranks), new_size, data):
        src, dst = old_ranks[p], new_ranks[q]
        if src == me:
            sc[dst] = hi - lo
            pieces.append(span[lo - p * old_size:hi - p * old_size])
        if dst == me:
            rc[src] = hi - lo
    send = torch.cat(pieces) if pieces else torch.empty(
        (0,), dtype=dtype, device=device)
    recv = torch.empty((sum(rc),), dtype=dtype, device=device)
    stage = _Stage()
    if world == 1:
        recv.copy_(send)
    else:
        staged = dist.get_backend() == "gloo" \
            and torch.device(device).type == "cuda"
        _rounds(send, sc, recv, rc, max(old_size, new_size), None, staged,
                stage)
    out = None
    if me in new_ranks:
        out = torch.zeros((new_size,), dtype=dtype, device=device)
        out[:recv.numel()] = recv
    item = torch.empty((), dtype=dtype).element_size()
    crossed = (sum(sc) - sc[me] + sum(rc) - rc[me]) * item
    _book("respan", crossed, time.perf_counter() - t0, stage.bytes)
    return out


# ---------------------------------------------------------------------------
# the tensor-parallel forward's collectives over a model line
# ---------------------------------------------------------------------------

class _CopyToModel(torch.autograd.Function):
    """Forward: ``x`` as it is (the residual stream is replicated over the
    model line). Backward: the gradient summed over the line, since each
    rank's slice of the weights sees its own part of it."""

    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        s = ctx.comm.summed(g.contiguous(), "copy_to_model", torch.float32)
        return s.to(g.dtype), None


class _ReduceFromModel(torch.autograd.Function):
    """Forward: the line's partial results summed (in f32, then cast to
    ``dtype``). Backward: the gradient as it is, to every rank's
    partial."""

    @staticmethod
    def forward(ctx, x, comm, dtype, scatter_dim):
        ctx.dtype_in = x.dtype
        if scatter_dim is None:
            out = comm.summed(x.contiguous(), "reduce_from_model",
                              torch.float32)
        else:
            # a reduce-scatter over ``scatter_dim``, then the all-gather
            # back: the port's residual stream stays replicated
            xm = x.to(torch.float32).movedim(scatter_dim, 0).contiguous()
            part = comm.reduce_scatter(xm.view(-1),
                                       name="moe_reduce_scatter")
            out = comm.all_gather(part, name="moe_all_gather").view(
                xm.shape).movedim(0, scatter_dim)
        return out.to(dtype)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype_in), None, None, None


@dataclasses.dataclass(frozen=True)
class ModelAxis:
    """This rank's line of a mesh's ``model`` axis: its ``size``, this
    rank's ``pos`` on it and the line's collectives (``comm``). The
    tensor-parallel layers call ``copy`` on the input of every
    computation split over the line, and ``reduce`` on its partial
    output; ``maxed`` is a forward-only elementwise maximum (the vocab
    shards' logit maxima, which carry no gradient)."""
    size: int
    pos: int
    comm: "MeshComm"

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        return _CopyToModel.apply(x, self.comm)

    def reduce(self, x: torch.Tensor, dtype=None,
               scatter_dim: Optional[int] = None) -> torch.Tensor:
        """The sum over the line of ``x`` in ``dtype`` (default ``x``'s);
        with ``scatter_dim`` through a reduce-scatter over that dim and an
        all-gather, the same bits."""
        return _ReduceFromModel.apply(x, self.comm, dtype or x.dtype,
                                      scatter_dim)

    def maxed(self, x: torch.Tensor) -> torch.Tensor:
        return self.comm.maxed(x.detach().contiguous(), "model_max")


def model_axis(ctx) -> Optional[ModelAxis]:
    """The :class:`ModelAxis` of a :class:`~repro_torch.sharding.partition.
    DistContext` whose mesh has a ``model`` axis of more than one rank;
    None otherwise (no ctx, no mesh, or a ``(n, 1)`` mesh: every rank runs
    the whole forward). Cached on the mesh."""
    mesh = None if ctx is None else ctx.mesh
    if mesh is None or ctx.tp is None or mesh.shape.get(ctx.tp, 1) == 1:
        return None
    axis = getattr(mesh, "_model_axis", None)
    if axis is None:
        line = mesh.axis_mesh(ctx.tp)
        axis = ModelAxis(line.size, mesh.axis_position(ctx.tp),
                         line.comm())
        mesh._model_axis = axis
    return axis


def data_comm(ctx) -> Optional[MeshComm]:
    """The :class:`MeshComm` of this rank's line of the mesh's ``data``
    axis (the ranks that hold the other data shards at this rank's model
    position; the mesh's ``data_line``); None without a mesh. Cached on
    the mesh."""
    mesh = None if ctx is None else ctx.mesh
    if mesh is None:
        return None
    comm = getattr(mesh, "_data_comm", None)
    if comm is None:
        comm = mesh.data_line([a for a in ctx.dp
                               if a in mesh.axis_names]).comm()
        mesh._data_comm = comm
    return comm
