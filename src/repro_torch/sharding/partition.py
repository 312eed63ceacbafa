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
state and gathers the arena for the forward. The ``model`` axis splits no
heads in the forward (tensor parallelism and the expert-parallel MoE are
ROADMAP item 38); it is kept for the specs, the block homes and the
survivor mesh.

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
