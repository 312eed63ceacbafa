"""The dry run: one rank's step of every (arch x input shape) on a mesh of
the reference's production shape, costed without the mesh.

The port of ``repro.launch.dryrun``. The reference lowers and compiles
each combination for all 256 (or 512) TPU chips of its mesh and reads
XLA's ``cost_analysis()``, ``memory_analysis()`` and the compiled HLO's
collectives. The port has no compiler to ask: it runs what one rank of
the mesh runs, on tensors of the ``meta`` device (shapes and dtypes, no
memory, no arithmetic), with every collective counted by a stand-in that
sends nothing. For every combination :func:`lower_combination`

1. builds a dry mesh of the production shape, ``(16, 16)`` ``("data",
   "model")`` or ``(2, 16, 16)`` with a ``pod`` axis, live at rank 0
   (``launch.mesh.make_dry_production_mesh``; every rank runs the same
   shapes), whose collectives are ``distributed.collectives.CountingComm``
   lines;
2. builds the rank's arguments on the meta device, cut as the rank holds
   them: its model slices of the parameters (``partition.model_slices``),
   its data shard of the batch and its slice of the serving cache
   (``init_cache(..., ctx=...)``);
3. runs the rank's step: ``train`` the arena step
   (``training.step.make_arena_train_step``) with adamw in
   ``cfg.opt_moment_dtype`` over the rank's span of the flat arena, a
   ``prefill`` ``ops.prefill``, a ``decode`` ``ops.decode_step`` on the
   cache of ``init_cache(cfg, batch, seq, ctx=...)``;
4. records, under the reference's keys: ``flops`` (from
   ``torch.utils.flop_counter.FlopCounterMode``), ``bytes_accessed``
   (each op's operand and result bytes, from a ``TorchDispatchMode``: an
   unfused count, each intermediate written and read again, so larger
   than XLA's fused one; views, in-place aliases and allocations count
   nothing), ``collectives`` (the stand-in's books: count and result
   bytes per reference kind, and ``total_bytes``) and ``memory``:
   ``argument_bytes`` (what the rank holds between steps: its arguments'
   storages), ``output_bytes`` (the storages the step makes that it
   returns) and ``temp_bytes`` (the peak of the bytes the step allocates
   and holds at once, its outputs included: what
   ``torch.cuda.max_memory_allocated`` over the step's baseline reads on
   the card).

**Why the arena step.** The reference lowers its FSDP train step: every
weight and moment sharded over ``data`` and ``model`` by its partition
specs, a layer's data shards gathered inside its remat scope (in the
forward and again in the recompute). The port's only data-sharded
training state is the flat arena (``partition.arena_sharding``): each
rank holds a span of the arena and of its moments. It gathers only the
words of its model slices (``partition.SlicePlan``, ``slice_gather``: a
sixteenth of the model at ``model`` 16), and those of each remat layer
only while the layer runs, in the forward and again in its recompute;
each layer's gradient goes to the spans' owners as the backward leaves
it (``slice_reduce``), the outer group's (embedding, head, norms) when
it ends. So a rank holds the outer group's slices, one layer's and their
gradient, its span's gradient and the remat checkpoints, never all its
slices at once. Its carry between layers is the rank's piece of the
sequence on the ``model`` line (Megatron SP, as the reference's train
stacks place it: ``models.layers.seq_axis``), so its remat checkpoints
are ``S / tp`` rows. The stand-in books each gather and each reduce as
the reference kinds they compute: an all-gather of the group's slices
and a reduce-scatter of the group's part of the rank's span; each
sequence-parallel gather an all-gather of the whole S and each of their
reduce-scatters one to the rank's piece. The sharded arena
holds an all-f32 model (``ArenaLayout.span_runs``), so the train step
runs the config in f32 (``param_dtype`` in the record). Its per-rank
bytes are reported as they are.

**What cannot run on meta, and what runs instead.**

- A scalar the step reads on the host: ``int(cache["pos"])`` in the
  dense, hybrid and encoder-decoder decode. The cache's ``pos`` is a real
  CPU tensor holding the shape's own position (the token after the
  ``seq`` it was filled with; a linear cache of ``seq`` slots its last
  slot). ``int(qpck.min())`` in ``layers._fwd_chunks`` (a banded prefill
  longer than its window) is not reached: no dry-run shape prefills a
  ring cache.
- The CUDA kernels (sw_attention, the SSD scan's ssd_intra) take CUDA
  tensors only: on meta the prefill takes the plain route the CPU takes
  (``flash_attention_triangle``, the chunked SSD scan), tile by tile, so
  the counter sees every attention tile (the reference adds them
  analytically: its flash tiles sit in rolled scans that ``cost_analysis``
  cannot see).
- Weights are made by the families' ``init_params`` under a function mode
  that puts every factory call on meta (:func:`meta_params`).

A failure is an ``ok: False`` record with its error, as in the
reference; nothing falls back. Combinations the port does not run are
``skipped``: the reference's rules (:func:`applicable`) and the port's own
(:func:`port_applicable`: heads whose whole-head ranges would cross kv
groups unevenly, which no config of the repo reaches at ``(16, 16)``).

**Uneven heads.** Where the query heads do not divide the ``model`` axis
(llama4-maverick's 40 and qwen2-1.5b's 12 at 16), the ranks hold
whole-head ranges one head apart (``partition.query_head_range``), the
largest at position 0, the rank the dry run costs. So its record bounds
every rank's, and its counts times the chips overstate the mesh's
attention by ``query_heads["rank0_over_mean"]`` (the record's
``query_heads``: rank 0's heads against the mean, ``Hq / tp``; 1.2 for
llama4-maverick, 1.33 for qwen2-1.5b at 16). The roofline carries it
beside its terms.

The multi-pod mesh ``(2, 16, 16)`` runs: its ``pod`` and ``data`` axes
are one data line of 32 ranks (the reference's pods are data parallelism
alone), so the data shard is a thirty-second of the batch.

**Depth.** An eager step runs each layer's ops one by one, and on meta a
32k-token prefill's attention is hundreds of thousands of tile ops a
layer. So a record's full-depth figures are extrapolated from the
family-aware depth probes (:func:`depth_costs`, the reference roofline's
rules: a layer at depths 1 and 2, the hybrid's Mamba2 layer and shared
block apart, the encoder-decoder's decoder and encoder apart, an
interleaved MoE model's layer pair). Every count is linear in the depth,
so they are exact; each probe's own figures stay in the record
(``probes``). A train step of ``microbatch > 1`` also keeps the counts
at ``microbatch=1`` that the roofline reads (``microbatch1``).

Usage: ``PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A]
[--shape S] [--mesh single|multi|both] [--outdir results/dryrun]
[--jobs N]``. Writes ``<outdir>/<arch>__<shape>__<mesh>.json``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
import weakref
from typing import Any, Callable, Optional

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten as _pt_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import get_config, list_configs
from repro_torch.data.synthetic import batch_specs, shape_params
from repro_torch.distributed import collectives
from repro_torch.launch.mesh import make_dry_production_mesh
from repro_torch.models import get_model
from repro_torch.sharding.partition import (batch_rows, check_tensor_parallel,
                                            make_dist_ctx, model_slices,
                                            query_head_range,
                                            take_model_slices)
from repro_torch.utils.tree import tree_map

SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


# long_500k needs a sub-quadratic serve path (see DESIGN.md):
#  - ssm / hybrid: recurrent state — native
#  - dense / moe / vlm: sliding-window ring cache variant (opt-in)
#  - audio (whisper): SKIPPED — 30 s enc-dec format, noted in DESIGN.md
def applicable(cfg, shape: str) -> tuple[bool, str]:
    if shape == "long_500k":
        if cfg.family == "audio":
            return False, "enc-dec 30s format: 500k decode out of family (DESIGN.md)"
        if cfg.family in ("dense", "moe", "vlm") and not cfg.sliding_window:
            return False, "full attention is quadratic at 500k"
    return True, ""


def port_applicable(cfg, mesh) -> tuple[bool, str]:
    """The port's own skips on ``mesh``: a config that does not split over
    its ``model`` axis (``partition.check_tensor_parallel``). The port
    splits whole query heads, as evenly as the count allows, each rank
    holding the kv heads its range reads; it skips a split whose ranges
    cross kv groups unevenly (the reference cuts ``head_dim`` where the
    heads do not divide). None of the repo's configs is skipped at
    ``(16, 16)``."""
    tp = mesh.shape.get("model", 1)
    try:
        check_tensor_parallel(cfg, tp)
    except ValueError as e:
        return False, f"port: not tensor-parallel at model={tp} ({e})"
    return True, ""


# ---------------------------------------------------------------------------
# the collectives' record
# ---------------------------------------------------------------------------

def collective_stats() -> dict:
    """Per-kind ``count`` and result ``bytes`` of every collective the
    rank's step called, and ``total_bytes``: the counting stand-in's books
    (``collectives.dry_stats``), the reference's accounting of its
    compiled collectives' result shapes."""
    return collectives.dry_stats()


# ---------------------------------------------------------------------------
# meta tensors
# ---------------------------------------------------------------------------

_FACTORIES = (torch.randn, torch.rand, torch.randint, torch.empty,
              torch.zeros, torch.ones, torch.full, torch.arange, torch.tensor,
              torch.linspace, torch.normal)
_RANDOM_METHODS = ("normal_", "uniform_", "exponential_", "random_",
                   "bernoulli_")


class _OnMeta(TorchFunctionMode):
    """Every factory call made on the meta device, its generator dropped."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if func in _FACTORIES:
            kwargs["device"] = "meta"
            kwargs.pop("generator", None)
        elif getattr(func, "__name__", "") in _RANDOM_METHODS:
            kwargs.pop("generator", None)
        return func(*args, **kwargs)


def meta_params(cfg) -> Any:
    """``cfg``'s parameter tree on the meta device (the family's
    ``init_params``, every draw on meta)."""
    with _OnMeta():
        return get_model(cfg).init_params(torch.Generator(), cfg,
                                          device="meta")


def _fresh(like: torch.Tensor, device) -> torch.Tensor:
    """A tensor of ``like``'s shape and dtype on ``device`` with its own
    storage: empty on meta, small normal draws elsewhere (the card's and
    the CPU's runs read their values, which the dry run never holds)."""
    t = torch.empty(like.shape, dtype=like.dtype, device=device)
    if t.device.type != "meta":
        if t.is_floating_point():
            t.normal_(0.0, 0.02)
        else:
            t.zero_()
    return t


# ---------------------------------------------------------------------------
# the rank's step
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RankStep:
    """One rank's step, ready to run: ``run()`` runs it once on
    ``args`` (the tensors the rank holds between steps: its parameters or
    arena span and moments, its cache, its batch shard)."""
    run: Callable[[], Any]
    args: Any
    info: dict


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def storage_bytes(tree) -> int:
    """The bytes of the distinct storages of ``tree``'s tensors."""
    seen = {}
    for x in _pt_flatten(tree)[0]:
        if isinstance(x, torch.Tensor):
            seen[_storage_key(x)] = x.untyped_storage().nbytes()
    return int(sum(seen.values()))


def _batch_shard(cfg, kind: str, batch: int, seq: int, ctx, device) -> dict:
    """The rank's data shard of the step's global batch
    (``data.synthetic.batch_specs``), on ``device``."""
    lo, hi = batch_rows(batch, ctx)
    out = {}
    for k, v in batch_specs(cfg, kind, batch, seq).items():
        t = torch.empty((hi - lo,) + tuple(v.shape[1:]), dtype=v.dtype,
                        device=device)
        if t.device.type != "meta":
            if t.is_floating_point():
                t.normal_()
            else:
                t.random_(0, cfg.vocab)
        out[k] = t
    return out


def build_rank_step(cfg, kind: str, batch: int, seq: int, mesh,
                    device="meta", *, cache_len: Optional[int] = None
                    ) -> RankStep:
    """The step that ``mesh``'s live position runs for ``cfg`` at a
    ``kind`` (``train``, ``prefill`` or ``decode``) of the global
    ``batch`` x ``seq``, on ``device``: on meta for the dry run, on the
    card or the CPU on real tensors of the same shapes. ``cache_len``
    (decode): a linear cache of that many slots in place of
    ``init_cache``'s (``serve_cache_len``) geometry."""
    from repro_torch.models import transformer
    ctx = make_dist_ctx(mesh, batch_shardable=(
        batch >= 1 and batch % _dp_total(mesh) == 0))
    if cfg.moe_no_fsdp:
        ctx = dataclasses.replace(ctx, expert_fsdp=False)
    ops = get_model(cfg)
    dev = torch.device(device)
    info = {"ctx": ctx, "cfg": cfg, "param_dtype": cfg.dtype}
    shard = _batch_shard(cfg, kind, batch, seq, ctx, dev)
    if kind == "train":
        return _train_step(cfg, ops, ctx, mesh, shard, dev, info)
    whole = meta_params(cfg)
    params = tree_map(lambda x: _fresh(x, dev),
                      take_model_slices(whole, model_slices(whole, ctx)))
    del whole
    if kind == "prefill":
        info["step"] = "prefill"

        def run():
            with torch.no_grad():
                return ops.prefill(params, shard, cfg, ctx)
        return RankStep(run, {"params": params, "batch": shard}, info)
    if cache_len is not None:
        spec = transformer.CacheSpec(cache_len=cache_len, ring=False)
        cache = transformer.init_cache(None, cfg, batch, spec, dev, ctx)
    else:
        cache = ops.init_cache(cfg, batch, seq, device=dev, ctx=ctx)
    slots = cache["k"].shape[2] if "k" in cache else seq
    ring = "k" in cache and slots < seq
    pos = seq if ring or "k" not in cache else min(seq, slots - 1)
    host_pos = torch.tensor(pos, dtype=torch.int32)
    if "pos" in cache:
        # int(cache["pos"]) is read on the host: a real value on meta
        cache["pos"] = host_pos if dev.type == "meta" \
            else host_pos.to(dev)
    if "kpos" in cache and dev.type != "meta":
        kept = torch.arange(pos - min(pos, slots), pos, dtype=torch.int32)
        cache["kpos"][(kept % slots).long().to(dev)] = kept.to(dev)
    info.update(step="serve_step", cache_len=slots, pos=pos)
    tokens = shard["tokens"]

    def run():
        with torch.no_grad():
            return ops.decode_step(params, cache, tokens, cfg, ctx)
    return RankStep(run, {"params": params, "cache": cache,
                          "tokens": tokens}, info)


def _train_step(cfg, ops, ctx, mesh, shard, dev, info) -> RankStep:
    """The arena step over the rank's span (see the module docstring)."""
    from repro_torch.core.arena import build_arena_layout
    from repro_torch.core.blocks import partition_pytree
    from repro_torch.models.layers import split_layers, torch_dtype
    from repro_torch.optim.optimizers import adamw
    from repro_torch.training.step import make_arena_train_step
    from repro_torch.training.train_state import ArenaTrainState
    cfg = dataclasses.replace(cfg, dtype="float32")
    info.update(cfg=cfg, param_dtype="float32", step="train_step")
    whole = split_layers(meta_params(cfg), ops.stacked_layers)
    layout = build_arena_layout(partition_pytree(whole, block_rows=128),
                                shards=mesh.size)
    del whole
    span = torch.empty((layout.shard_words,), dtype=torch.float32,
                       device=dev)
    if dev.type != "meta":
        span.normal_(0.0, 0.02)
    optimizer = adamw(3e-4, moment_dtype=torch_dtype(cfg.opt_moment_dtype))
    state = ArenaTrainState.create(span.view(torch.int32), optimizer, layout)
    comm = mesh.comm()
    step = make_arena_train_step(ops, cfg, optimizer, layout, comm, ctx)
    info.update(arena_words=layout.total_words, slice_plan=step.plan)

    def run():
        out = step(state, shard)
        step.release()
        return out
    return RankStep(run, {"state": [state.arena, state.opt_state.mu,
                                    state.opt_state.nu],
                          "batch": shard}, info)


# ---------------------------------------------------------------------------
# the costs of a step
# ---------------------------------------------------------------------------

# allocations, aliases, host reads and the making of a constant from a
# Python number (``torch.tensor``: ``lift_fresh`` on the CPU,
# ``scalar_tensor`` on meta) move no bytes
_FREE = {"empty", "empty_strided", "empty_like", "new_empty",
         "new_empty_strided", "detach", "alias", "lift_fresh",
         "scalar_tensor", "_local_scalar_dense", "set_", "resize_"}


class StepCosts(TorchDispatchMode):
    """Counts each op's bytes (operands and results; views, aliases and
    allocations none) and the live bytes of the storages made under it,
    with their peak (a storage is freed when its last tensor is)."""

    def __init__(self, args=None):
        super().__init__()
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._known = set()
        self._new = {}
        if args is not None:
            for x in _pt_flatten(args)[0]:
                if isinstance(x, torch.Tensor):
                    self._known.add(_storage_key(x))

    def _freed(self, key: int, n: int) -> None:
        self.live -= n
        self._new.pop(key, None)

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._known or key in self._new:
            return
        n = st.nbytes()
        self._new[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._freed, key, n)

    def new_bytes(self, tree) -> int:
        """The bytes of the storages of ``tree`` that this step made."""
        keys = {}
        for x in _pt_flatten(tree)[0]:
            if isinstance(x, torch.Tensor):
                k = _storage_key(x)
                if k in self._new:
                    keys[k] = self._new[k]
        return int(sum(keys.values()))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = [x for x in _pt_flatten((args, kwargs))[0]
               if isinstance(x, torch.Tensor)]
        outs = [x for x in _pt_flatten(out)[0]
                if isinstance(x, torch.Tensor)]
        name = func._schema.name.split("::")[-1]
        mutates = any(a.alias_info is not None and a.alias_info.is_write
                      for a in func._schema.arguments)
        in_keys = {_storage_key(x) for x in ins}
        aliased = outs and all(_storage_key(o) in in_keys for o in outs)
        if name not in _FREE and (mutates or not aliased):
            self.bytes += sum(x.numel() * x.element_size()
                              for x in ins + outs)
        for o in outs:
            self._track(o)
        return out


def measure(step: RankStep) -> dict:
    """Run ``step`` once under the counters: its ``flops``,
    ``bytes_accessed``, the stand-in's collectives and its memory (see the
    module docstring), with the seconds the run took."""
    collectives.reset_stats()
    collectives.reset_dry_stats()
    args_bytes = storage_bytes(step.args)
    t0 = time.perf_counter()
    with FlopCounterMode(display=False) as fc:
        with StepCosts(step.args) as cm:
            out = step.run()
        outputs = cm.new_bytes(out)
    seconds = time.perf_counter() - t0
    rec = {"flops": float(fc.get_total_flops()),
           "bytes_accessed": float(cm.bytes),
           "collectives": collective_stats(),
           "memory": {"argument_bytes": args_bytes,
                      "output_bytes": outputs,
                      "temp_bytes": int(cm.peak),
                      "generated_code_bytes": None},
           "run_s": seconds,
           "stats": collectives.seconds_and_bytes()}
    del out
    return rec


def lower_combination(arch: str, shape: str, mesh, *, overrides=None,
                      device="meta") -> tuple[dict, dict]:
    """Build and run the rank's step of ``arch`` at ``shape`` on ``mesh``
    (see the module docstring). Returns (the costs, meta). Raises where
    the step fails."""
    cfg = dataclasses.replace(get_config(arch), **(overrides or {}))
    sp = shape_params(shape)
    step = build_rank_step(cfg, sp["kind"], sp["batch"], sp["seq"], mesh,
                           device)
    costs = measure(step)
    meta = {k: v for k, v in step.info.items()
            if k not in ("ctx", "cfg", "slice_plan")}
    return costs, meta


# ---------------------------------------------------------------------------
# depth probes
# ---------------------------------------------------------------------------

# the costs a probe reads, each linear in the depth of an eager step
PROBE_KEYS = ("flops", "bytes", "coll", "argument_bytes", "output_bytes",
              "temp_bytes")


def _probe_record(costs: dict) -> dict:
    m = costs["memory"]
    return {"flops": costs["flops"], "bytes": costs["bytes_accessed"],
            "coll": float(costs["collectives"]["total_bytes"]),
            "argument_bytes": float(m["argument_bytes"]),
            "output_bytes": float(m["output_bytes"]),
            "temp_bytes": float(m["temp_bytes"]),
            "collectives": costs["collectives"], "run_s": costs["run_s"]}


def probe(arch: str, shape: str, mesh, device="meta", **overrides) -> dict:
    """The rank's step of ``arch`` at ``shape`` with ``overrides`` (a
    probe's depth), run once: its :data:`PROBE_KEYS` costs."""
    costs, _ = lower_combination(arch, shape, mesh, overrides=overrides,
                                 device=device)
    return _probe_record(costs)


def probe_plan(cfg) -> tuple[list, Callable]:
    """The family-aware depth probes of ``cfg`` (the reference roofline's
    ``corrected_costs`` rules) and the function that extrapolates their
    costs to ``cfg``'s full depth: ``nonlayer + sum_unit n_unit *
    delta_unit``. The hybrid probes its Mamba2 layer and its shared
    attention block apart, the encoder-decoder its decoder and encoder
    layers, an interleaved MoE model a (dense, MoE) layer pair, every
    other model one layer."""
    if cfg.family == "hybrid":
        from repro_torch.models.hybrid import n_segments
        plan = [dict(n_layers=1, attn_every=1), dict(n_layers=2,
                                                     attn_every=2),
                dict(n_layers=2, attn_every=1)]

        def full(pa, pb, pc, k):
            mamba, shared = pb[k] - pa[k], pc[k] - pb[k]
            return (pa[k] - mamba - shared + cfg.n_layers * mamba
                    + n_segments(cfg) * shared)
        return plan, full
    if cfg.family == "audio":
        plan = [dict(n_layers=1, enc_layers=1), dict(n_layers=2,
                                                     enc_layers=1),
                dict(n_layers=1, enc_layers=2)]

        def full(pa, pb, pc, k):
            dec, enc = pb[k] - pa[k], pc[k] - pa[k]
            return (pa[k] - dec - enc + cfg.n_layers * dec
                    + cfg.enc_layers * enc)
        return plan, full
    if cfg.n_experts and cfg.moe_every > 1:
        plan, n = [dict(n_layers=2), dict(n_layers=4)], cfg.n_layers // 2
    else:
        plan, n = [dict(n_layers=1), dict(n_layers=2)], cfg.n_layers

    def full(p1, p2, k):
        return (p1[k] - (p2[k] - p1[k])) + n * (p2[k] - p1[k])
    return plan, full


def depth_costs_of(cfg, kind: str, batch: int, seq: int, mesh,
                   device="meta", cache_len: Optional[int] = None
                   ) -> tuple[dict, list]:
    """:func:`depth_costs` of a config and a step given outright (``kind``,
    the global ``batch`` x ``seq``, a decode's linear ``cache_len``)."""
    plan, full = probe_plan(cfg)
    probes = []
    for p in plan:
        step = build_rank_step(dataclasses.replace(cfg, **p), kind, batch,
                               seq, mesh, device, cache_len=cache_len)
        probes.append(_probe_record(measure(step)))
    costs = {k: max(float(full(*probes, k)), 0.0) for k in PROBE_KEYS}
    return costs, [dict(p, depth=d) for p, d in zip(probes, plan)]


def depth_costs(arch: str, shape: str, mesh, extra=None,
                device="meta") -> tuple[dict, list]:
    """The rank's full-depth :data:`PROBE_KEYS` costs of ``arch`` at
    ``shape`` with the ``extra`` overrides, extrapolated from its depth
    probes (:func:`probe_plan`), and the probes. In an eager step a layer
    runs the same ops at every depth, so the serve steps' counts are
    linear in the depth and their extrapolation exact; the train step's
    ``flops`` too, while its ``bytes``, ``coll`` and ``argument_bytes``
    move the whole arena, whose tile alignment (the tail's and the
    shards') adds under two tiles a shard whatever the depth (0.03% at a
    reduced config). ``temp_bytes`` (a peak) is linear where the peak
    falls at the same point of the step at every depth."""
    cfg = dataclasses.replace(get_config(arch), **(extra or {}))
    sp = shape_params(shape)
    return depth_costs_of(cfg, sp["kind"], sp["batch"], sp["seq"], mesh,
                          device)


def _dp_total(mesh) -> int:
    n = 1
    for a in ("pod", "data"):
        if a in mesh.axis_names:
            n *= mesh.shape[a]
    return n


def mesh_name(mesh) -> str:
    """The record's name of ``mesh``: the reference's ``pod16x16`` and
    ``pod2x16x16`` for the production shapes, ``mesh<a>x<b>`` else."""
    dims = tuple(mesh.shape.values())
    if dims == (16, 16):
        return "pod16x16"
    if dims == (2, 16, 16) and "pod" in mesh.axis_names:
        return "pod2x16x16"
    return "mesh" + "x".join(str(d) for d in dims)


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------

def _one_thread(fn, args):
    torch.set_num_threads(1)
    return fn(*args)


def in_processes(fn, todo: list, jobs: int):
    """``fn(*args)`` for each of ``todo``, in order: here with ``jobs``
    1, else in ``jobs`` processes at once (one torch thread each)."""
    if jobs <= 1:
        for args in todo:
            yield fn(*args)
        return
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(jobs, mp_context=ctx) as pool:
        futures = [pool.submit(_one_thread, fn, args) for args in todo]
        for f in futures:
            yield f.result()


def _full_record(arch: str, shape: str, mesh, extra: dict) -> tuple:
    """The full-depth costs of ``arch`` at ``shape`` with ``extra`` on
    ``mesh``'s live rank (:func:`depth_costs`): those costs, each
    collective kind's count and bytes extrapolated as they are, and the
    probes."""
    full, probes = depth_costs(arch, shape, mesh, extra)
    _, extrapolate = probe_plan(dataclasses.replace(get_config(arch),
                                                    **extra))
    kinds = {}
    for k in collectives.KINDS:
        kinds[k] = {f: int(round(max(float(extrapolate(
            *[{"v": p["collectives"][k][f]} for p in probes], "v")), 0.0)))
            for f in ("count", "bytes")}
    kinds["total_bytes"] = int(round(full["coll"]))
    return full, kinds, probes


def dry_record(arch: str, shape: str, mesh, overrides=None) -> dict:
    """The dry run's record of ``arch`` at ``shape`` (with the config
    ``overrides``) on ``mesh``'s live rank: ``skipped`` with the
    reference's reason or the port's, or the reference's keys from the
    depth probes' full-depth costs, or ``ok: False`` with the error. A
    train step of ``microbatch > 1`` is probed again at ``microbatch=1``
    (the reference roofline's counts: gradient accumulation repeats the
    same work), kept under ``microbatch1`` (``flops``, ``bytes``,
    ``coll``, ``probes``)."""
    overrides = dict(overrides or {})
    rec = {"arch": arch, "shape": shape, "mesh": mesh_name(mesh),
           "ok": False}
    cfg = dataclasses.replace(get_config(arch), **overrides)
    ok, why = applicable(cfg, shape)
    if ok:
        ok, why = port_applicable(cfg, mesh)
    if not ok:
        rec.update(skipped=True, reason=why, ok=True)
        return rec
    kind = shape_params(shape)["kind"]
    step = {"train": "train_step", "prefill": "prefill"}.get(kind,
                                                              "serve_step")
    t0 = time.time()
    try:
        full, kinds, probes = _full_record(arch, shape, mesh, overrides)
        rec.update(
            ok=True, step=step,
            param_dtype="float32" if step == "train_step" else cfg.dtype,
            lower_s=round(time.time() - t0, 1), compile_s=0.0,
            flops=full["flops"], bytes_accessed=full["bytes"],
            collectives=kinds,
            memory={"argument_bytes": full["argument_bytes"],
                    "output_bytes": full["output_bytes"],
                    "temp_bytes": full["temp_bytes"],
                    "generated_code_bytes": None},
            depth="extrapolated from the depth probes",
            probes=probes)
        if cfg.n_heads:
            rec["query_heads"] = query_heads(cfg, mesh)
        if kind == "train" and cfg.microbatch > 1:
            one, _, p1 = _full_record(arch, shape, mesh,
                                      {**overrides, "microbatch": 1})
            rec["microbatch1"] = {"flops": one["flops"],
                                  "bytes": one["bytes"],
                                  "coll": one["coll"], "probes": p1}
    except Exception as e:  # a failure here is a bug in the port
        rec.update(ok=False, error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
    return rec


def query_heads(cfg, mesh) -> dict:
    """The query heads of ``mesh``'s live rank (``live``) and of model
    position 0 (``rank0``) against the mean a rank holds, ``Hq / tp``:
    ``rank0_over_mean`` is the factor by which rank 0's attention counts,
    times the chips, overstate the mesh's (1 where the heads split
    evenly)."""
    tp = mesh.shape.get("model", 1)
    pos = mesh.axis_position("model") if tp > 1 else 0
    lo, hi = query_head_range(cfg.n_heads, cfg.n_kv_heads, tp, pos)
    first = query_head_range(cfg.n_heads, cfg.n_kv_heads, tp, 0)[1]
    mean = cfg.n_heads / tp
    return {"live": hi - lo, "rank0": first, "mean": mean,
            "rank0_over_mean": first / mean}


def record_path(outdir: str, arch: str, shape: str, mesh: str) -> str:
    return os.path.join(outdir, f"{arch}__{shape}__{mesh}.json")


def run_one(arch: str, shape: str, multi_pod: bool, outdir: str) -> dict:
    """:func:`dry_record` on rank 0 of the production mesh, written to
    ``outdir``."""
    rec = dry_record(arch, shape,
                     make_dry_production_mesh(multi_pod=multi_pod))
    if outdir:
        os.makedirs(outdir, exist_ok=True)
        with open(record_path(outdir, arch, shape, rec["mesh"]), "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all", choices=SHAPES + ["all"])
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--outdir", default="results/dryrun")
    ap.add_argument("--jobs", type=int, default=1,
                    help="combinations run at once, one process each")
    args = ap.parse_args(argv)

    archs = list_configs() if args.arch == "all" else [args.arch]
    shapes = SHAPES if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    todo = [(a, s, mp, args.outdir)
            for a in archs for s in shapes for mp in meshes]

    n_fail = 0
    for rec in in_processes(run_one, todo, args.jobs):
        status = ("SKIP " + rec.get("reason", "") if rec.get("skipped")
                  else ("OK" if rec["ok"] else "FAIL " + rec.get("error", "")))
        print(f"[dryrun] {rec['arch']:28s} {rec['shape']:12s} "
              f"{rec['mesh']:10s} {status}", flush=True)
        if rec["ok"] and not rec.get("skipped"):
            m = rec["memory"]
            print(f"         flops={rec['flops']:.3e} "
                  f"bytes={rec['bytes_accessed']:.3e} "
                  f"coll={rec['collectives']['total_bytes']:.3e} "
                  f"args/rank={m['argument_bytes']:.3e} "
                  f"temp/rank={m['temp_bytes']:.3e} "
                  f"(run {rec['lower_s']}s)", flush=True)
        n_fail += 0 if rec["ok"] else 1
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
