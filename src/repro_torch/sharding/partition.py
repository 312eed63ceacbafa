"""Distribution context, partition specs and failure domains over a mesh.

The port of ``repro.sharding.partition``. ``DistContext`` carries the mesh
(:class:`repro_torch.launch.mesh.Mesh`, one ``torch.distributed`` rank per
position) and the logical-to-mesh axis mapping, and is a no-op context
without one (``single_device_ctx``).

Partition specs are tuples of axis names (``None``: replicated), the
reference's ``PartitionSpec`` entries one for one (:class:`PartitionSpec`,
a tuple that the tree utilities keep as one leaf); the shape-to-spec
functions return what the reference's return for the same tree and mesh
shape. On a mesh the port computes FSDP over the flat arena
(:func:`arena_sharding`): every rank holds its span of the arena-shaped
state and gathers the arena for the forward. The ``model`` axis splits
the transformer families' forward (tensor and expert parallelism):
:func:`model_slices` gives each leaf's cut for this rank, from the specs'
``model`` entries mapped onto the port's leaves (the reference's stacked
ones and the trainer's per-layer ones), and :func:`take_model_slices`
takes them as views.

- 2-D weights (d_in, d_out): TP on the "wide" axis, FSDP (data) on the
  other; embeddings (V, D): vocab on TP, D on data; expert weights (E,
  d_in, d_out): experts on TP, d_in on data; biases, norms and small
  vectors: replicated.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np

from repro_torch.utils.tree import (flatten_with_path, keystr, tree_map,
                                    tree_unflatten)

PyTree = Any


class PartitionSpec(tuple):
    """One leaf's spec: an entry per dim, an axis name, a tuple of axis
    names or None. Equal to the plain tuple of its entries."""
    tree_leaf = True

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


@dataclasses.dataclass(frozen=True)
class DistContext:
    mesh: Optional[Any] = None
    dp: tuple[str, ...] = ("data",)   # batch axes (("pod", "data") multi-pod)
    tp: Optional[str] = "model"
    batch_shardable: bool = True      # False for a global batch < |dp|
    expert_fsdp: bool = True          # False: expert weights expert-parallel

    @property
    def dp_spec(self):
        """The batch dim's spec entry (None when the batch cannot split)."""
        if not self.batch_shardable or not self.dp:
            return None
        return self.dp if len(self.dp) > 1 else self.dp[0]

    @property
    def raw_dp_spec(self):
        """The batch axes' spec entry regardless of ``batch_shardable``."""
        if not self.dp:
            return None
        return self.dp if len(self.dp) > 1 else self.dp[0]

    @property
    def tp_size(self) -> int:
        if self.mesh is None or self.tp is None:
            return 1
        return self.mesh.shape[self.tp]


def single_device_ctx() -> DistContext:
    return DistContext(mesh=None, dp=(), tp=None)


def make_dist_ctx(mesh, batch_shardable: bool = True) -> DistContext:
    names = mesh.axis_names
    dp = tuple(a for a in names if a in ("pod", "data"))
    tp = "model" if "model" in names else None
    return DistContext(mesh=mesh, dp=dp, tp=tp,
                       batch_shardable=batch_shardable)


# ---------------------------------------------------------------------------
# Parameter partition specs
# ---------------------------------------------------------------------------

def _key(name: str) -> str:
    """The trailing dict key of a leaf name (the leaf's role)."""
    return name.rsplit("'", 2)[-2] if "'" in name else name


def _spec_for_leaf(name: str, shape: tuple[int, ...],
                   ctx: DistContext) -> PartitionSpec:
    """FSDP+TP spec by leaf-name convention and rank; layer-stacked leaves
    have a leading L dim that is never sharded."""
    tp = ctx.tp
    d = "data" if ctx.mesh is not None \
        and "data" in ctx.mesh.axis_names else None
    key = _key(name)
    if tp is None:
        return ()

    def divides(dim: int) -> bool:
        return dim % ctx.tp_size == 0

    if key in ("embed", "lm_head"):                   # (V, D)
        return (*([None] * (len(shape) - 2)), tp, d)
    if key in ("w_gate_experts", "w_up_experts"):     # (L, E, D, F)
        return (None, tp, d if ctx.expert_fsdp else None, None)
    if key in ("w_down_experts",):                    # (L, E, F, D)
        return (None, tp, None, d if ctx.expert_fsdp else None)
    if key in ("wq", "wk", "wv"):                     # (L, D, H, Dh)
        if divides(shape[-2]):
            return (None, d, tp, None)
        return (None, d, None, tp)
    if key in ("wo",):                                # (L, H, Dh, D)
        if divides(shape[-3]):
            return (None, tp, None, d)
        return (None, None, tp, d)
    if key in ("w_gate", "w_up"):                     # (L, D, F)
        return (None, d, tp)
    if key in ("w_down",):                            # (L, F, D)
        return (None, tp, d)
    if key in ("in_proj", "out_proj", "proj", "router"):
        if len(shape) == 3:
            return (None, d, tp)
        if len(shape) == 2:
            return (d, tp)
        return ()
    return ()


def _fit_spec(shape: tuple[int, ...], spec: PartitionSpec,
              ctx: DistContext) -> PartitionSpec:
    """Drop axis assignments that do not divide their dim (GQA's 2 KV heads
    over model=16 fall back to replicated there)."""
    if ctx.mesh is None:
        return PartitionSpec()
    sizes = dict(ctx.mesh.shape)
    out = []
    for dim, entry in zip(shape,
                          tuple(spec) + (None,) * (len(shape) - len(spec))):
        if entry is None:
            out.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        total = 1
        for a in axes:
            total *= sizes[a]
        out.append(entry if dim % total == 0 else None)
    return PartitionSpec(*out)


def _specs(tree: PyTree, ctx: DistContext, rule) -> PyTree:
    flat, treedef = flatten_with_path(tree)
    specs = []
    for path, leaf in flat:
        shape = tuple(leaf.shape)
        specs.append(_fit_spec(shape, rule(keystr(path), shape, ctx), ctx))
    return tree_unflatten(treedef, specs)


def param_partition_specs(params_shape: PyTree, ctx: DistContext) -> PyTree:
    """Spec tree of a params tree (leaves need only ``.shape``)."""
    return _specs(params_shape, ctx, _spec_for_leaf)


def _state_spec_for_leaf(name: str, shape: tuple[int, ...],
                         ctx: DistContext) -> PartitionSpec:
    """Serving-state (KV cache, SSM state) specs by leaf name."""
    if ctx.mesh is None or ctx.tp is None:
        return ()
    tp = ctx.tp
    dp = ctx.dp_spec
    seq_dp = None if ctx.batch_shardable else ctx.raw_dp_spec
    key = _key(name)
    if key in ("k", "v", "cross_k", "cross_v") and len(shape) == 5:
        if shape[-2] % ctx.tp_size == 0:
            return (None, dp, seq_dp, tp, None)
        return (None, dp, seq_dp, None, tp)
    if key in ("k_scale", "v_scale") and len(shape) == 4:
        if shape[-1] % ctx.tp_size == 0:
            return (None, dp, seq_dp, tp)
        return (None, dp, seq_dp, None)
    if key == "h" and len(shape) == 5:
        return (None, dp, tp, None, None)
    if key == "conv" and len(shape) == 4:
        return (None, dp, None, tp)
    return ()


def state_partition_specs(state_shape: PyTree, ctx: DistContext) -> PyTree:
    return _specs(state_shape, ctx, _state_spec_for_leaf)


def batch_partition_specs(batch_shape: PyTree, ctx: DistContext) -> PyTree:
    """Input batch specs: the leading batch dim over the dp axes."""
    return tree_map(lambda x: PartitionSpec(
        ctx.dp_spec, *([None] * (len(x.shape) - 1))), batch_shape)


# ---------------------------------------------------------------------------
# Flat arena sharding
# ---------------------------------------------------------------------------

def arena_sharding(mesh, layout) -> list[tuple[int, int]]:
    """The flat 1-D sharding of the arena over every mesh axis: mesh
    position ``i`` (row-major) owns the word span ``[i * total / n, (i + 1)
    * total / n)``, whole tiles when ``layout.shards`` is the mesh size."""
    n = int(np.asarray(mesh.devices).size)
    if layout.shards != n:
        raise ValueError(f"the layout has {layout.shards} shards, the mesh "
                         f"{n} positions")
    return [layout.span(i) for i in range(n)]


def shard_arena_state(state, mesh):
    """This rank's shard of an ``ArenaTrainState`` of full buffers: the
    arena and every 1-D moment buffer cut to the rank's span (the moments
    are value-domain buffers, equal to the word domain on a sharded
    all-f32 layout); the step count is replicated. Other positions' spans
    are dropped."""
    from repro_torch.optim.optimizers import OptState
    from repro_torch.training.train_state import ArenaTrainState
    w0, w1 = state.layout.span(mesh.position())

    def cut(x):
        if hasattr(x, "dim") and x.dim() == 1:
            return x[w0:w1].clone()
        return x
    opt = state.opt_state
    return ArenaTrainState(cut(state.arena), OptState(
        opt.step, *(cut(m) if hasattr(m, "dim") else m
                    for m in (opt.mu, opt.nu))), state.step, state.layout)


# ---------------------------------------------------------------------------
# Failure domains: mesh devices -> parameter blocks
# ---------------------------------------------------------------------------

def block_device_homes(partition, n_devices: int) -> np.ndarray:
    """(total_blocks,) int32: the data-axis slice ("device") holding each
    block's rows under FSDP row-sharding.

    Each leaf's leading rows are split into ``n_devices`` equal spans; the
    block's first real row decides its home. This is the *initial*
    placement the checkpoint fabric seeds its mutable
    :class:`~repro_torch.fabric.placement.ClusterView` with; after a domain
    loss the elastic placement engine re-homes displaced blocks, so the
    current homing always lives in the view.
    """
    homes = np.zeros((partition.total_blocks,), np.int32)
    for leaf in partition.leaves:
        span = max(1, leaf.rows // n_devices)
        for b in range(leaf.n_blocks):
            row = min(b * partition.block_rows, leaf.rows - 1)
            homes[leaf.offset + b] = min(row // span, n_devices - 1)
    return homes


def blocks_on_failed_devices(partition, params_shape: PyTree,
                             ctx: DistContext,
                             failed_device_fraction: float,
                             rng: np.random.Generator) -> np.ndarray:
    """Topology-aware failure: a random contiguous slice of the data axis
    (a "host") fails, and every block whose rows are homed there is lost.
    Draws from ``rng`` as the reference does."""
    n_data = ctx.mesh.shape.get("data", 1) if ctx.mesh is not None else 1
    n_fail = max(1, round(failed_device_fraction * n_data))
    start = int(rng.integers(0, n_data))
    failed = [(start + i) % n_data for i in range(n_fail)]
    homes = block_device_homes(partition, n_data)
    return np.isin(homes, failed)


# ---------------------------------------------------------------------------
# The model axis's slices of the tensor-parallel forward
# ---------------------------------------------------------------------------

# the rank of each rule's leaf in the reference's stacked layout
_STACKED_NDIM = {"embed": 2, "lm_head": 2, "wq": 4, "wk": 4, "wv": 4,
                 "wo": 4, "w_gate": 3, "w_up": 3, "w_down": 3,
                 "w_gate_experts": 4, "w_up_experts": 4, "w_down_experts": 4}
# held 2-D in the per-layer layout (models.layers.split_layers): their
# heads or experts lead dim 0
_HELD_2D = ("wo", "w_gate_experts", "w_up_experts", "w_down_experts")
# the specs cut them over ``model`` for storage; the forward computes them
# whole on every rank (the reference's MoE takes its router replicated,
# ``P()``, and the VLM's projector is a replicated prefix)
_COMPUTE_REPLICATED = ("router", "proj")
# replicated in the specs; the forward adds each rank's heads' rows
_HEAD_BIASES = ("bq", "bk", "bv")


def _model_dim(name: str, shape: tuple[int, ...],
               ctx: DistContext) -> Optional[int]:
    """The dim of a leaf that the ``model`` axis cuts in the forward, or
    None (computed whole): the dim of its spec's ``model`` entry
    (:func:`_spec_for_leaf`, on the leaf's stacked shape), mapped onto the
    leaf."""
    key = _key(name)
    if key in _COMPUTE_REPLICATED:
        return None
    if key in _HEAD_BIASES:
        return len(shape) - 2
    if key in _HELD_2D and len(shape) == 2:
        return 0
    want = _STACKED_NDIM.get(key)
    if want is None:
        return None
    lead = max(want - len(shape), 0)
    spec = _spec_for_leaf(name, (1,) * lead + tuple(shape), ctx)
    for i, entry in enumerate(spec):
        axes = entry if isinstance(entry, tuple) else (entry,)
        if ctx.tp in axes:
            return i - lead
    return None


class ModelSlice(tuple):
    """One leaf's cut: ``(dim, lo, hi)``, or empty for a leaf computed
    whole. A tuple that the tree utilities keep as one leaf."""
    tree_leaf = True

    def __new__(cls, *entries):
        return super().__new__(cls, entries)


WHOLE = ModelSlice()


def model_slices(tree: PyTree, ctx: DistContext, pos: Optional[int] = None
                 ) -> PyTree:
    """For each leaf of ``tree`` (leaves need only ``.shape``), the
    :class:`ModelSlice` that model position ``pos`` (default: this rank's)
    computes with: ``(dim, lo, hi)``, or :data:`WHOLE` for a leaf every
    rank computes whole (every leaf when the mesh's ``model`` axis has one
    position). Raises ``ValueError`` for a cut dim that does not split
    evenly."""
    tp = ctx.tp_size
    flat, treedef = flatten_with_path(tree)
    if tp == 1:
        return tree_unflatten(treedef, [WHOLE] * len(flat))
    if pos is None:
        pos = ctx.mesh.axis_position(ctx.tp)
    out = []
    for path, leaf in flat:
        shape = tuple(leaf.shape)
        dim = _model_dim(keystr(path), shape, ctx)
        if dim is None:
            out.append(WHOLE)
            continue
        n = shape[dim]
        if n % tp:
            raise ValueError(f"{keystr(path)}: dim {dim} of {shape} does not "
                             f"split over model={tp}")
        per = n // tp
        out.append(ModelSlice(dim, pos * per, (pos + 1) * per))
    return tree_unflatten(treedef, out)


def take_model_slices(tree: PyTree, slices: PyTree) -> PyTree:
    """``tree`` with each leaf cut to its slice (:func:`model_slices`), as
    views: a gradient taken through them lands in the whole leaves'."""
    return tree_map(lambda x, s: x.narrow(s[0], s[1], s[2] - s[1])
                    if s else x, tree, slices)


def check_tensor_parallel(cfg, tp: int) -> None:
    """Raise ``ValueError`` naming ``cfg`` when its heads, kv heads,
    experts, feed-forward widths or vocab do not split over ``tp`` model
    positions. The reference splits ``head_dim`` where the heads do not
    divide; the port does not (no config does so at the meshes it
    trains)."""
    dims = {"n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
            "n_experts": cfg.n_experts, "d_ff": cfg.d_ff,
            "d_ff_dense": cfg.d_ff_dense, "vocab": cfg.vocab}
    bad = {k: v for k, v in dims.items() if v % tp}
    if bad:
        raise ValueError(f"{cfg.name}: {bad} do not split over model={tp} "
                         "(tensor parallelism needs every one to divide)")
