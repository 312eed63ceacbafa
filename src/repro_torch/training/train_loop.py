"""The LM trainer with SCAR fault tolerance as a first-class feature: the
port of ``repro.training.train_loop``.

``TrainLoop`` owns:

- the train step (loss, gradient and optimizer update;
  :mod:`repro_torch.training.step`);
- an :class:`repro_torch.core.controller.FTController` over the
  *parameter* tree (optimizer moments are recoverable state too: SCAR
  checkpoints the params, and the moments kept after a partial restore are
  a perturbation the theory covers);
- **arena-resident training state** (the default when the controller's
  fabric is arena-capable): the live params are the flat word arena
  (:class:`~repro_torch.training.train_state.ArenaTrainState`), updated in
  place by the step, and the per-step controller calls
  (``maintain``/``maybe_checkpoint``) read ``state.arena`` directly: the
  maintenance sweep runs without a pack and the partial save sources
  straight from the training state. The PyTree path stays available with
  ``TrainLoopConfig(arena_state=False)``;
- failure injection (the iteration drawn per step with ``fail_prob``, as
  in the paper's §5.3): the paper's uniform block loss or a whole-domain
  loss (``fail_domain="host"``) routed through the fabric's tier planner;
- trace-driven soaks (``mtbf``, ``fail_schedule``): failed domains stay
  dead in the fabric's view and heal ``heal_after`` steps later, with
  per-event tier counts in ``metrics`` and ``controller.stats["events"]``;
  bit flips (``flip_schedule``) and integrity scrubs
  (``scrub_interval``);
- the disk mirror (``store=``, a
  :class:`~repro_torch.checkpoint_io.ShardedCheckpointStore`), flushed at
  the end of every ``run``;
- async maintenance (``FabricConfig(async_maintain=True)``): the sweep of
  step ``t`` runs on a side stream under step ``t + 1``; the loop takes no
  fence on a clean step, and the pending epoch settles at the next
  maintain, at a save, a recovery, a heal or a scrub, and at the end of
  ``run``.

It trains every family: dense, moe (every layer MoE, or dense and MoE
layers interleaved; the loss carries the router's aux losses), vlm (its
batches carrying ``patches``, the patch prefix out of the loss), ssm,
hybrid (a Mamba2 backbone and one shared attention block) and audio (the
encoder-decoder, its batches carrying ``frames``). The device is explicit
(``cuda`` unless asked otherwise; the trainer raises where no CUDA device
is present rather than moving to the CPU).

**On a mesh** (``ctx``, a :class:`~repro_torch.sharding.partition.
DistContext` whose mesh is one ``torch.distributed`` rank a position) the
arena-resident state is flat-sharded over every rank (each holds its span
of the arena and of the moments; :mod:`repro_torch.training.step` gathers
the arena for the forward and reduce-scatters the gradient). The dense,
MoE and VLM families split their forward over the mesh's ``model`` axis
(tensor and expert parallelism, each rank on its model slices of the
gathered leaves) and their batch over the data positions; the mesh's
process groups (its ``model`` and ``data`` lines) are made with it, and
a shrink to the ``(n, 1)`` survivor mesh collapses the ``model`` axis:
every survivor runs the whole forward on its own rows. The initial
weights come from one source (``params``, or the mesh's first rank's draw,
broadcast), and the controller's fabric sweeps each rank's span. The
PyTree state holds the whole tree on every rank. **The elastic mesh**
(``elastic_mesh``; on by default for arena-resident state on a mesh with a
meshed ``FabricConfig(elastic=True)``): after a domain loss the mesh
shrinks to the survivors (the largest count that divides the global batch
and that the alive devices cover; survivors keep their logical ids), the
state's spans move to the new layout bit for bit, the step is rebuilt and
the tiers are refreshed on the new placement; a heal re-grows it. A rank
left out of the shrunk mesh stays alive and skips the steps (it keeps the
fabric's bookkeeping, takes every step's loss from the mesh and rejoins at
the re-grow).
"""
from __future__ import annotations

import dataclasses
import gc
import time
import warnings
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.controller import FTController
from repro_torch.core.policy import CheckpointPolicy
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import get_model
from repro_torch.optim.optimizers import Optimizer, OptState, adamw
from repro_torch.data.pipeline import model_parallel
from repro_torch.sharding.partition import (DistContext,
                                            check_tensor_parallel,
                                            make_dist_ctx, single_device_ctx)
from repro_torch.telemetry.recorder import NULL_RECORDER, Histogram
from repro_torch.training.step import make_arena_train_step, make_train_step
from repro_torch.training.train_state import ArenaTrainState, TrainState
from repro_torch.utils.tree import tree_leaves

PyTree = Any


@dataclasses.dataclass
class TrainLoopConfig:
    policy: Optional[CheckpointPolicy] = None
    fail_prob: float = 0.0          # per-iteration geometric failure prob
    fail_fraction: float = 0.5      # fraction of blocks lost per failure
    fail_domain: str = "uniform"    # "uniform" | "device" | "host" | "rack"
    fabric: Optional[Any] = None    # FabricConfig -> tiered recovery fabric
    # arena-resident training state: the live params ARE the flat arena
    # (needs an arena-capable fabric). When requested but the fabric
    # cannot engage it, the loop warns and records ``fabric/arena_gated``
    # before taking the PyTree path; False picks the tree path silently.
    arena_state: bool = True
    # elastic mesh: with a meshed elastic fabric, a domain loss shrinks the
    # mesh to the survivors (state moved to the new layout, step rebuilt,
    # training continues) and a heal re-grows it. None = on exactly when
    # arena-resident state runs on a mesh with an elastic fabric
    elastic_mesh: Optional[bool] = None
    # record per-step maintenance overhead (``overhead_seconds`` in
    # metrics): in sync mode waits for the sweep's device work each step,
    # so the number is the maintenance work, not its launch; async mode
    # never waits there (the un-hidden rest of a sweep books at its
    # deferred fence, in the fabric's fence histogram)
    measure_overhead: bool = True
    # trace-driven soaks: per-domain-kind MTBF means (in steps) sampled
    # into a multi-event failure schedule each run(); failed domains stay
    # dead and optionally heal ``heal_after`` steps later
    mtbf: Optional[dict] = None     # e.g. {"host": 200.0, "device": 80.0}
    # deterministic schedule: (step, kind, index) triples or FailureEvents
    fail_schedule: Optional[list] = None
    heal_after: Optional[int] = None
    # silent-error soak: in-arena bit flips at these steps, an int step
    # (random block/word/bit) or a (step, block) pair
    flip_schedule: Optional[list] = None
    # integrity-scrub cadence in steps (0 = never)
    scrub_interval: int = 0
    # hold each layer's weights as leaves of their own (a list under each
    # stacked key of the family: "layers", or "enc_layers" and
    # "dec_layers"), every attention's wo as a (Hq*Dh, D) leaf and every
    # MoE block's expert stacks as (E*D, F) and (E*F, D) leaves
    # (models.layers.split_layers), in place of the reference's stacked
    # leaves. The partition cuts blocks along dim 0, so a stacked leaf is
    # one SCAR block spanning every layer, a (Hq, Dh, D) wo one block of
    # Hq*Dh*D values and an (E, D, F) expert stack one block of D*F values
    # an expert; the parity frames are as wide as the widest block. At
    # full width FabricConfig()'s XOR parity needs 616 GB stacked and
    # 5.4 GB split for qwen2-1.5b, 6.9 GB split against 124 GB with the
    # layers split alone for one internvl2-76b layer. False keeps the
    # reference's stacked partition, block for block (what a comparison
    # with the reference needs).
    per_layer_leaves: bool = True
    # telemetry sink (repro_torch.telemetry.Recorder); default NULL_RECORDER
    recorder: Optional[Any] = None
    log_every: int = 10
    seed: int = 0

    def __post_init__(self):
        if self.fail_domain != "uniform" and self.fabric is None:
            raise ValueError("correlated fail_domain injection needs a "
                             "fabric (set TrainLoopConfig.fabric)")
        if (self.mtbf is not None or self.fail_schedule) \
                and self.fabric is None:
            raise ValueError("trace-driven soak mode needs a fabric "
                             "(set TrainLoopConfig.fabric)")
        if (self.flip_schedule or self.scrub_interval) \
                and self.fabric is None:
            raise ValueError("bit-flip injection / integrity scrubs need "
                             "a fabric (set TrainLoopConfig.fabric)")


class TrainLoop:
    """``TrainLoop(cfg, optimizer, loop_cfg, store, device=..., ctx=...)``:
    the trainer of one model on one device, or on this rank's device of a
    mesh (``ctx``). ``optimizer`` defaults to ``adamw(3e-4)``; ``store``
    is the controller's disk mirror."""

    def __init__(self, cfg: ModelConfig,
                 optimizer: Optional[Optimizer] = None,
                 loop_cfg: Optional[TrainLoopConfig] = None,
                 store=None, *, device: DeviceLike = None,
                 ctx: Optional[DistContext] = None):
        self.cfg = cfg
        self.ctx = ctx if ctx is not None else single_device_ctx()
        self._store = store
        self.device = resolve_device(device)
        self.ops = get_model(cfg)
        self.optimizer = optimizer or adamw(3e-4)
        self.loop_cfg = loop_cfg or TrainLoopConfig()
        self._rng = np.random.default_rng(self.loop_cfg.seed)
        self.controller: Optional[FTController] = None
        self.metrics: list[dict] = []
        self._redundancy_flags: list[bool] = []
        self.arena_layout = None          # set when the arena path engages
        self.recorder = (self.loop_cfg.recorder
                         if self.loop_cfg.recorder is not None
                         else NULL_RECORDER)
        # clean-step maintenance-overhead distribution (overhead_summary's
        # p50/p95/max), shared with a real recorder by name, and its split
        # into sweep, save and fence
        self._overhead_hist = self._hist("train/overhead_seconds")
        self._sweep_hist = self._hist("train/sweep_seconds")
        self._save_hist = self._hist("train/save_seconds")
        self._fence_hist = self._hist("train/fence_seconds")
        # the mesh: the base (full) mesh, the one the step runs on now, the
        # logical device at each of its positions, whether a resize has
        # happened, and this rank's collectives on it (None outside it)
        self._base_mesh = self._cur_mesh = self.ctx.mesh
        self._cur_ctx = self.ctx
        if model_parallel(cfg, self.ctx):
            check_tensor_parallel(cfg, self.ctx.tp_size)
        self._mesh_logical = (None if self._base_mesh is None else
                              np.arange(self._base_mesh.size, dtype=np.int32))
        self._mesh_resized = False
        self._last_batch_dim = None
        self._comm = None
        if self._base_mesh is not None:
            from repro_torch.distributed.collectives import MeshComm
            self._comm = MeshComm(self._base_mesh)
        self._train_step = make_train_step(self.ops, cfg, self.optimizer)
        self._arena_step = None           # built by init_state

    def _hist(self, name: str) -> Histogram:
        return (self.recorder.histogram(name) if self.recorder.enabled
                else Histogram())

    # -- initialization ------------------------------------------------------

    def init_state(self, gen: Optional[torch.Generator] = None,
                   params: Optional[PyTree] = None):
        """Fresh training state: random weights from ``gen`` (default: a
        generator on the device seeded ``loop_cfg.seed``), or ``params``,
        a numpy tree (e.g. the reference's parameters after
        ``np.asarray``), carried to the device by
        ``interop.from_numpy_tree``. Builds the controller, and the arena
        form of the state when its fabric is arena-capable."""
        mesh = self._base_mesh
        if params is not None:
            from repro_torch.interop import from_numpy_tree
            params = from_numpy_tree(params, self.device)
        else:
            if gen is None:
                gen = torch.Generator(device=self.device).manual_seed(
                    self.loop_cfg.seed)
            params = self.ops.init_params(gen, self.cfg, device=self.device)
            if mesh is not None:
                # one source: the mesh's first rank's draw (the other
                # ranks' own draws only size the buffers it overwrites)
                for x in tree_leaves(params):
                    self._comm.broadcast(x)
        if self.loop_cfg.per_layer_leaves:
            from repro_torch.models.layers import split_layers
            params = split_layers(params, self.ops.stacked_layers)
        if self.loop_cfg.policy is not None:
            try:
                self.controller = FTController(
                    params, self.loop_cfg.policy, store=self._store,
                    fabric=self.loop_cfg.fabric,
                    recorder=self.loop_cfg.recorder, device=self.device,
                    mesh=mesh)
            except ValueError as e:
                if mesh is not None and self.recorder.enabled:
                    # the mesh has no tree-path fallback: say why, then stop
                    self.recorder.event("fabric/arena_gated", reason=str(e))
                raise
        if mesh is not None:
            if self.controller is None:
                raise ValueError("training on a mesh needs a CheckpointPolicy "
                                 "and a FabricConfig (the arena layout is the "
                                 "fabric's)")
            if not self.loop_cfg.arena_state:
                self._train_step = make_train_step(
                    self.ops, self.cfg, self.optimizer,
                    self.controller.arena_layout, self._comm, self.ctx)
                return TrainState.create(params, self.optimizer)
        if (self.loop_cfg.arena_state and self.controller is not None
                and self.controller.arena_ready):
            # arena-resident state: pack once here, never again; every
            # step updates the arena in place and the controller reads it
            self.arena_layout = self.controller.arena_layout
            self._arena_step = make_arena_train_step(
                self.ops, self.cfg, self.optimizer, self.arena_layout,
                self._comm, self.ctx)
            arena = self.controller.pack_live(params)
            del params
            return ArenaTrainState.create(arena, self.optimizer,
                                          self.arena_layout)
        if self.loop_cfg.arena_state and self.controller is not None \
                and self.loop_cfg.fabric is not None:
            # asked for (the default) with a fabric that could not build an
            # arena layout: say so rather than take the tree path silently
            msg = ("arena_state=True but the fabric is not arena-capable "
                   "(word-unpackable dtype such as f64/int64/bool, custom "
                   "scorer or partial tiers); falling back to PyTree "
                   "training state (per-step packs). Set "
                   "TrainLoopConfig(arena_state=False) to silence.")
            warnings.warn(msg, stacklevel=2)
            if self.recorder.enabled:
                self.recorder.event("fabric/arena_gated", reason=msg)
        return TrainState.create(params, self.optimizer)

    # -- live-state plumbing (both representations) --------------------------

    @staticmethod
    def _live(state):
        """The live parameters in their canonical form: the flat arena of
        an ArenaTrainState, the tree of a TrainState. The controller takes
        either."""
        return state.arena if isinstance(state, ArenaTrainState) \
            else state.params

    @staticmethod
    def _with_live(state, new_live):
        if isinstance(state, ArenaTrainState):
            return ArenaTrainState(new_live, state.opt_state, state.step,
                                   state.layout)
        return TrainState(new_live, state.opt_state, state.step)

    # -- the elastic mesh ------------------------------------------------------

    def _member(self) -> bool:
        """False on a rank left out of the current (shrunk) mesh."""
        return self._cur_mesh is None or self._cur_mesh.is_member()

    def _elastic_enabled(self, state) -> bool:
        """Whether this run() may shrink and re-grow the mesh on domain
        events: arena-resident state on a mesh with an elastic meshed
        fabric. ``elastic_mesh=True`` without them is a configuration
        error, not a silent no-op."""
        want = self.loop_cfg.elastic_mesh
        if want is False:
            return False
        fab = self.controller.fabric if self.controller is not None else None
        ok = (isinstance(state, ArenaTrainState)
              and self._base_mesh is not None
              and fab is not None and fab.cfg.elastic
              and fab.mesh is not None)
        if want and not ok:
            raise ValueError(
                "elastic_mesh=True needs arena-resident state on a mesh "
                "with an elastic meshed fabric (FabricConfig(elastic=True) "
                "and a DistContext mesh whose size matches n_devices)")
        return ok

    def _place_batch(self, batch):
        """The rank's slice of the global batch on the current (shrunk)
        mesh; None outside it."""
        from repro_torch.data.pipeline import slice_batch
        return slice_batch(batch.global_rows, self._cur_mesh, self.device,
                           model_parallel(self.cfg, self._cur_ctx))

    def _idle(self, state):
        """A step of a rank outside the mesh: nothing computed, the step
        counts advanced so the rank rejoins in step."""
        opt = state.opt_state
        return ArenaTrainState(None, OptState(opt.step + 1, None, None),
                               state.step + 1, state.layout)

    def _shared_loss(self, loss) -> float:
        """The step's loss as a float on every rank: ranks outside the
        current mesh take the mesh's first rank's."""
        import torch.distributed as dist
        mesh = self._cur_mesh
        value = None if loss is None else float(loss)
        if mesh is None or not dist.is_initialized() \
                or mesh.size == dist.get_world_size():
            return value
        box = [value]
        dist.broadcast_object_list(box, src=mesh.ranks[0])
        return box[0]

    def _maybe_resize(self, state, step: int, rec: dict):
        """Shrink or re-grow the mesh to the fabric's alive devices.

        The survivor count is the largest k <= alive that divides the
        global batch; the survivors keep their logical ids, on a ``(k,
        1)`` mesh (``tp = 1``: each runs the whole forward on its rows),
        and a whole re-grow returns to the base mesh and its ctx. The
        arena and
        the moments move to the new layout bit for bit (one all-to-all
        each, :func:`~repro_torch.distributed.collectives.respan`), the
        step is rebuilt for the new mesh, the controller's checkpoint
        follows, and a forced maintain refreshes every tier on the new
        placement. Every rank takes part."""
        from repro_torch.distributed.collectives import MeshComm, respan
        from repro_torch.launch.mesh import mesh_devices, survivor_mesh
        t0 = time.perf_counter()
        fab = self.controller.fabric
        alive = fab.view.alive_devices()
        k = int(alive.size)
        bdim = self._last_batch_dim or k
        while k > 1 and bdim % k != 0:
            k -= 1
        survivors = alive[:k]
        if np.array_equal(survivors, self._mesh_logical):
            return state
        base = mesh_devices(self._base_mesh)
        if k == len(base):
            new_mesh = self._base_mesh    # a whole re-grow: the base shape
        else:
            new_mesh = survivor_mesh([base[int(i)] for i in survivors])
        old, old_ranks = self.arena_layout, self._cur_mesh.ranks
        new = fab.resize_mesh(new_mesh, survivors, step=step)
        new_ranks = new_mesh.ranks
        dev = self.device

        def move(x, words: bool):
            return respan(x, old_ranks, old.shard_words, new_ranks,
                          new.shard_words,
                          old.data_words if words
                          else old.total_values - old.pad_words,
                          torch.int32 if words else torch.float32, dev)

        opt = state.opt_state
        # the optimizer's moments move (a rank outside the old mesh holds
        # None and takes part); those it does not have (sgd: none,
        # momentum: one) stay None on every rank
        n = self.optimizer.n_moments
        moments = tuple(move(m, False) if i < n else m
                        for i, m in enumerate((opt.mu, opt.nu)))
        arena = move(state.arena, True)
        # the caller's state is spent: let its old spans go now
        state.arena = state.opt_state = None
        state = ArenaTrainState(arena, OptState(opt.step, *moments),
                                state.step, new)
        del opt, arena
        self._cur_mesh = new_mesh
        self._mesh_logical = survivors
        self._mesh_resized = True
        member = new_mesh.is_member()
        self._comm = MeshComm(new_mesh) if member else None
        self._cur_ctx = (self.ctx if new_mesh is self._base_mesh
                         else make_dist_ctx(new_mesh))
        self._arena_step = make_arena_train_step(
            self.ops, self.cfg, self.optimizer, new, self._comm,
            self._cur_ctx)
        self.arena_layout = new
        self.controller.rebind_arena(old_ranks, new_ranks)
        if dev.type == "cuda":
            # the old shard count's buffers go back to the card: the ranks
            # that share it (a rank left out holds nothing now) need the room
            gc.collect()
            torch.cuda.empty_cache()
        # the tiers were invalidated by the re-home and re-stripe: refresh
        # them from the moved live spans on the new placement
        fab.maintain(step, state.arena, force=True)
        fab.block_until_maintained()
        rec["mesh_resize"] = {"shards": int(new.shards),
                              "alive_devices": int(alive.size),
                              "seconds": time.perf_counter() - t0}
        return state

    # -- run loop -------------------------------------------------------------

    def run(self, state, batches, n_steps: int,
            on_step: Optional[Callable[[int, float], None]] = None):
        it = iter(batches)
        events_at = self._sample_trace(n_steps)
        heal_at: dict[int, list] = {}
        flips_at: dict[int, list] = {}
        for fl in (self.loop_cfg.flip_schedule or []):
            s, blk = (int(fl[0]), int(fl[1])) \
                if isinstance(fl, (tuple, list)) else (int(fl), None)
            flips_at.setdefault(max(1, min(s, n_steps)), []).append(blk)
        elastic = self._elastic_enabled(state)
        if self._base_mesh is not None and flips_at:
            raise ValueError("bit flips on a mesh are not injected (the "
                             "replica span a rank holds is another's)")
        for i in range(1, n_steps + 1):
            # re-read each iteration: an elastic resize rebuilds the step
            step_fn = (self._arena_step if isinstance(state, ArenaTrainState)
                       else self._train_step)
            batch = next(it)
            if self._base_mesh is not None:
                self._last_batch_dim = batch.global_batch
                if self._mesh_resized:
                    batch = self._place_batch(batch)
            member = self._member()
            t0 = time.perf_counter()
            with self.recorder.span("train_step", step=i):
                if member:
                    state, loss = step_fn(state, batch)
                    loss = float(loss)   # waits for the step
                else:
                    state, loss = self._idle(state), None
                loss = self._shared_loss(loss)
            dt = time.perf_counter() - t0
            rec = {"step": int(state.step), "loss": loss, "seconds": dt}
            if not member:
                rec["idle"] = True

            if self.controller is not None:
                # maintain first: the sweep scores the blocks against the
                # running checkpoint in the same read, and a same-step
                # partial save below reuses those scores
                tm0 = time.perf_counter()
                live = self._live(state)
                if member:
                    self.controller.maintain(int(state.step), live)
                t_maint = time.perf_counter()
                with self.recorder.span("save", step=int(state.step)):
                    if member and self.controller.maybe_checkpoint(
                            int(state.step), live):
                        rec["checkpointed"] = True
                t_save = time.perf_counter()
                fab = self.controller.fabric
                async_mode = fab is not None and fab.cfg.async_maintain
                # per-step fault-tolerance overhead (maintain + save),
                # without the rare failure/heal events timed below. Sync
                # mode waits for the sweep's device work first, so a
                # maintain-only step books the sweep, not its launch;
                # async mode must not wait (hiding the sweep under the next
                # step is the point): it books the launch, and the sweep's
                # un-hidden rest books at the deferred fence
                t_fence = t_save
                if self.loop_cfg.measure_overhead:
                    if fab is not None and not async_mode:
                        fab.block_until_maintained()
                        t_fence = time.perf_counter()
                    rec["overhead_seconds"] = t_fence - tm0
                evs = events_at.pop(i, [])
                if len(evs) > 1:
                    # simultaneous multi-domain loss: one tier-planned pass
                    # over the union, every event resolved against the
                    # pre-failure view
                    names = ",".join(f"{e.kind}:{e.index}" for e in evs)
                    with self.recorder.span("recovery", step=int(state.step),
                                            domain=names):
                        live, info = self.controller.on_domain_events(
                            live, [(e.kind, e.index) for e in evs],
                            step=int(state.step))
                    state = self._with_live(state, live)
                    rec.setdefault("failures", []).append(info)
                    if self.loop_cfg.heal_after is not None:
                        applied = {(a["kind"], a["index"])
                                   for a in info.get("events", [])}
                        for ev in evs:
                            if (ev.kind, ev.index) in applied:
                                heal_at.setdefault(
                                    i + self.loop_cfg.heal_after,
                                    []).append(ev)
                elif evs:
                    ev = evs[0]
                    with self.recorder.span("recovery", step=int(state.step),
                                            domain=f"{ev.kind}:{ev.index}"):
                        live, info = self.controller.on_domain_event(
                            live, ev.kind, ev.index, step=int(state.step))
                    state = self._with_live(state, live)
                    rec.setdefault("failures", []).append(info)
                    if (self.loop_cfg.heal_after is not None
                            and not info.get("skipped")):
                        heal_at.setdefault(i + self.loop_cfg.heal_after,
                                           []).append(ev)
                for ev in heal_at.pop(i, []):
                    with self.recorder.span("heal", step=int(state.step),
                                            domain=f"{ev.kind}:{ev.index}"):
                        heal = self.controller.heal_domain(
                            ev.kind, ev.index, live, step=int(state.step))
                    rec.setdefault("heals", []).append(heal)
                if elastic and ("failures" in rec or "heals" in rec):
                    # the survivor set changed: shrink the mesh to the
                    # alive devices (or re-grow after a heal), move the
                    # state, rebuild the step; training goes on there
                    live = None
                    state = self._maybe_resize(state, int(state.step), rec)
                for blk in flips_at.pop(i, []):
                    # soft-error injection: corrupt the replica snapshot
                    # invisibly; only the scrub (or a later replica
                    # recovery's measured perturbation) sees it
                    if fab is not None and fab.replicas is not None \
                            and fab.replicas.arena is not None:
                        where = fab.inject_arena_bit_flip(block=blk,
                                                          rng=self._rng)
                        rec.setdefault("bit_flips", []).append(where)
                if (self.loop_cfg.scrub_interval
                        and i % self.loop_cfg.scrub_interval == 0):
                    with self.recorder.span("scrub", step=int(state.step)):
                        sc = self.controller.scrub(step=int(state.step))
                    if sc["checked"]:
                        rec["scrub"] = {"detected": sc["detected"],
                                        "corrected": sc["corrected"]}
                if (self.loop_cfg.fail_prob > 0
                        and self._rng.random() < self.loop_cfg.fail_prob):
                    with self.recorder.span("recovery",
                                            step=int(state.step)):
                        new_live, info = self._inject(state)
                    state = self._with_live(state, new_live)
                    rec["failure"] = info
                # clean-step overhead sample: failure and heal steps are
                # left out, so the distribution answers "what does fault
                # tolerance cost when nothing is on fire"
                if "overhead_seconds" in rec and "failures" not in rec \
                        and "heals" not in rec and "failure" not in rec:
                    self._overhead_hist.observe(rec["overhead_seconds"])
                    self._sweep_hist.observe(t_maint - tm0)
                    self._save_hist.observe(t_save - t_maint)
                    if not async_mode:
                        self._fence_hist.observe(t_fence - t_save)
                if fab is not None:
                    # per-step placement health, folded into
                    # availability_summary()
                    full = fab.redundancy_state()["full"]
                    rec["redundancy_full"] = full
                    self._redundancy_flags.append(full)
            self.metrics.append(rec)
            if on_step is not None:
                on_step(i, loss)
        # the epoch boundary: settle the in-flight async sweep and drain
        # the store's background writer, so run() returns with the
        # redundancy published and on disk; the arena step's gradient
        # accumulator is let go until the next run
        if self._arena_step is not None:
            self._arena_step.release()
        if self.controller is not None:
            if self.controller.fabric is not None:
                self.controller.fabric.block_until_maintained()
            if self.controller.store is not None:
                self.controller.store.flush()
        return state

    def availability_summary(self) -> dict:
        """This loop's soak accounting (per-event tier counts and per-step
        redundancy flags) as the availability/goodput report of
        :func:`repro_torch.fabric.availability.summarize_availability`."""
        from repro_torch.fabric.availability import summarize_availability
        events = (self.controller.stats["events"]
                  if self.controller is not None else [])
        out = summarize_availability(events, self._redundancy_flags)
        if self.recorder.enabled:
            led = self.recorder.ledger.summary()
            out["telemetry"] = {
                "events_total": len(self.recorder.events),
                "recoveries_priced": led["n_events"],
                "iterations_owed_total": led["iterations_owed_total"]}
        return out

    def overhead_summary(self) -> dict:
        """Per-step wall-clock split (train step against fault-tolerance
        maintain + save) and the fabric's accounted maintenance bytes. The
        ``overhead_seconds_*`` distribution covers clean steps only, from
        the telemetry histogram; ``phases`` splits it into ``sweep`` (the
        maintain call), ``save`` (maybe_checkpoint) and ``fence`` (the
        wait for the sweep's device work: the loop's sync-mode waits and the
        fabric's deferred async fences). ``overlap_efficiency`` is the share
        of the async sweeps' wall time hidden under the steps (0.0 in sync
        mode) and ``async_maintains`` their count."""
        steps = [m["seconds"] for m in self.metrics]
        over = self._overhead_hist.summary()
        out = {"steps": len(steps),
               "step_seconds_mean": float(np.mean(steps)) if steps else 0.0,
               "overhead_seconds_mean": over["mean"],
               "overhead_seconds_p50": over["p50"],
               "overhead_seconds_p95": over["p95"],
               "overhead_seconds_max": over["max"],
               "overhead_clean_steps": over["count"],
               "arena_state": self.arena_layout is not None}
        fab = (self.controller.fabric
               if self.controller is not None else None)
        fence = Histogram()
        fence.samples = list(self._fence_hist.samples)
        if fab is not None:
            fence.samples += list(fab.fence_hist.samples)
        out["phases"] = {"sweep": self._sweep_hist.summary(),
                         "save": self._save_hist.summary(),
                         "fence": fence.summary()}
        out["overlap_efficiency"] = (fab.overlap_efficiency()
                                     if fab is not None else 0.0)
        if fab is not None:
            # one parity encode per maintained step under the default
            # same-interval tiers: the per-step denominator
            maintains = max(fab.stats["parity_encodes"], 1)
            out["maintain_bytes_per_step"] = (
                fab.stats["maintain_bytes_moved"] // maintains)
            out["arena_resident_maintains"] = \
                fab.stats["arena_resident_maintains"]
            out["async_maintains"] = fab.stats["async_maintains"]
        return out

    def _sample_trace(self, n_steps: int) -> dict[int, list]:
        """One run()'s soak schedule: loop iteration -> events, from the
        mtbf-sampled trace and ``fail_schedule``. Empty without either (or
        without a fabric to recover with)."""
        if self.controller is None or self.controller.fabric is None:
            return {}
        from repro_torch.fabric.domains import FailureEvent
        trace = []
        if self.loop_cfg.mtbf is not None:
            trace += self.controller.fabric.domains.sample_failure_trace(
                self._rng, n_steps, self.loop_cfg.mtbf)
        if self.loop_cfg.fail_schedule:
            trace += [ev if isinstance(ev, FailureEvent)
                      else FailureEvent(int(ev[0]), str(ev[1]), int(ev[2]))
                      for ev in self.loop_cfg.fail_schedule]
        events_at: dict[int, list] = {}
        for ev in sorted(trace, key=lambda e: e.step):
            events_at.setdefault(max(1, min(ev.step, n_steps)),
                                 []).append(ev)
        return events_at

    def _inject(self, state) -> tuple[Any, dict]:
        """One failure of the configured model (uniform or a domain);
        returns the recovered live value in the state's own form."""
        live = self._live(state)
        if self.loop_cfg.fail_domain == "uniform":
            lost = self.controller.sample_failure(self.loop_cfg.fail_fraction)
            return self.controller.on_failure(live, lost,
                                              step=int(state.step))
        lost, failed = self.controller.sample_domain_failure(
            self.loop_cfg.fail_domain)
        return self.controller.on_failure(live, lost,
                                          failed_devices=failed,
                                          step=int(state.step))

    def inject_failure(self, state, fraction: Optional[float] = None,
                       ) -> tuple[Any, dict]:
        """Explicit failure injection (experiments and examples)."""
        if self.controller is None:
            raise RuntimeError("enable a CheckpointPolicy first")
        if fraction is not None:
            lost = self.controller.sample_failure(fraction)
            new_live, info = self.controller.on_failure(
                self._live(state), lost, step=int(state.step))
        else:
            new_live, info = self._inject(state)
        return self._with_live(state, new_live), info
