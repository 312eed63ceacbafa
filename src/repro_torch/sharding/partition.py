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
state and gathers the words of its model slices alone, a layer's while
the layer runs (:class:`SlicePlan`: each slice as strided boxes of arena
words, grouped by layer, who sends which words to whom, and who
contributes to each word's gradient).
The ``model`` axis splits
every family's forward (tensor and expert parallelism):
:func:`model_slices` gives each leaf's cut for this rank, from the specs'
``model`` entries mapped onto the port's leaves (the reference's stacked
ones and the trainer's per-layer ones), and :func:`take_model_slices`
takes them. Two cuts differ from the specs on purpose: a Mamba2 mixer is
cut by SSD heads (the reference's even cut of the fused ``in_proj``
columns would run across its z, x, B, C and dt parts; ``out_proj`` is cut
by rows where the specs place its ``D`` columns), and a vocab that does
not split is computed whole (the reference's :func:`_fit_spec` drops the
axis there).

Serving on a mesh cuts the state too: :func:`state_slices` gives each
cache or SSM-state leaf its :class:`StateSlice` as the reference's
``_state_spec_for_leaf`` places it (the batch's data shard,
:func:`batch_rows`, then the kv heads, the SSD heads or the conv
channels).

**Whole query heads, as even as the count allows.** Model position ``r``
of ``tp`` computes the query heads ``[ceil(r Hq / tp), ceil((r+1) Hq /
tp))`` (:func:`query_head_range`): the even cut where ``Hq % tp == 0``,
else ranges one head apart, the largest at position 0 (llama4-maverick's
40 heads at ``tp`` 16: 3, 2, 3, 2, ...; qwen2-1.5b's 12 at 16: 1, 1, 1,
0, ...: a position may hold none). A rank holds whole kv heads, those its
query heads read (:func:`kv_head_range`), and the ranks whose query heads
read one kv head each hold a copy of it: ``wk``, ``wv``, ``bk``, ``bv``
and the cache's ``k``, ``v``, ``k_scale``, ``v_scale`` (a cut leaf whose
slices overlap, its gradient each rank's part). ``wq``, ``bq`` and
``wo`` are cut by the query range (``wo`` held 2-D by its rows ``[lo
Dh, hi Dh)``). The split is taken where every rank's range lies inside
one kv group or covers whole kv groups (:func:`kv_split`), so each rank's
query group is uniform; :func:`check_tensor_parallel` raises elsewhere.
The reference cuts ``head_dim`` where the heads do not split; the
function computed is the same.

- 2-D weights (d_in, d_out): TP on the "wide" axis, FSDP (data) on the
  other; embeddings (V, D): vocab on TP, D on data; expert weights (E,
  d_in, d_out): experts on TP, d_in on data; biases, norms and small
  vectors: replicated.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.utils.tree import (flatten_with_path, keystr, tree_flatten,
                                    tree_leaves, tree_map, tree_unflatten)

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

# the rank of each rule's leaf in the reference's stacked layout (an
# attention's leaves are cut by whole heads, :func:`_attention_slice`)
_STACKED_NDIM = {"embed": 2, "lm_head": 2, "w_gate": 3, "w_up": 3,
                 "w_down": 3, "w_gate_experts": 4, "w_up_experts": 4,
                 "w_down_experts": 4}
# held 2-D in the per-layer layout (models.layers.split_layers): their
# experts lead dim 0
_HELD_2D = ("w_gate_experts", "w_up_experts", "w_down_experts")
# the specs cut them over ``model`` for storage; the forward computes them
# whole on every rank (the reference's MoE takes its router replicated,
# ``P()``, and the VLM's projector is a replicated prefix)
_COMPUTE_REPLICATED = ("router", "proj")


def _model_dim(name: str, shape: tuple[int, ...],
               ctx: DistContext) -> Optional[int]:
    """The dim of a leaf other than an attention's that the ``model`` axis
    cuts in the forward, or None (computed whole): the dim of its spec's
    ``model`` entry (:func:`_spec_for_leaf`, on the leaf's stacked shape),
    mapped onto the leaf."""
    key = _key(name)
    if key in _COMPUTE_REPLICATED:
        return None
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
    """One leaf's cut: ``(dim, lo, hi)``, a range of ``dim``; ``(dim, lo0,
    hi0, lo1, hi1, ...)``, several ranges of it taken in that order (the
    Mamba2 ``in_proj``'s); or empty for a leaf computed whole. A tuple
    that the tree utilities keep as one leaf."""
    tree_leaf = True

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    @property
    def ranges(self) -> list[tuple[int, int]]:
        """The ``(lo, hi)`` ranges of ``dim``, in order."""
        return list(zip(self[1::2], self[2::2]))


WHOLE = ModelSlice()

# the Mamba2 mixer's leaves, cut by SSD heads (:func:`_mixer_slice`)
# whatever the specs place: the reference's even column cut of the fused
# ``in_proj`` runs across its z, x, B, C and dt boundaries
_MIXER = ("in_proj", "conv_w", "A_log", "dt_bias", "D_skip", "out_proj")
# where the vocab does not split over the model axis the embedding and the
# head are computed whole (the reference's ``_fit_spec`` drops the axis)
_VOCAB = ("embed", "lm_head")


def _parent(name: str) -> str:
    return name[:name.rindex("[")]


# the attention's kv-head leaves, cut by the kv heads their rank's query
# heads read (:func:`kv_head_range`)
_KV = ("wk", "wv", "bk", "bv")
# the attention's query-head leaves, cut by the rank's query heads
# (:func:`query_head_range`): never by ``head_dim``, which the specs fall
# back to where the heads do not split
_Q = ("wq", "bq", "wo")


def query_head_range(n_heads: int, n_kv_heads: int, tp: int, pos: int
                     ) -> tuple[int, int]:
    """The query heads ``[lo, hi)`` that model position ``pos`` of ``tp``
    computes: ``[ceil(pos Hq / tp), ceil((pos+1) Hq / tp))``, the even cut
    where ``Hq % tp == 0``, else ranges as even as the count allows (the
    largest at position 0; empty where ``Hq < tp``). Raises ``ValueError``
    where :func:`kv_split` is False."""
    if not kv_split(n_heads, n_kv_heads, tp):
        raise ValueError(_split_error(n_heads, n_kv_heads, tp))
    return _q_range(n_heads, tp, pos)


def _q_range(n_heads: int, tp: int, pos: int) -> tuple[int, int]:
    return -(-pos * n_heads // tp), -(-(pos + 1) * n_heads // tp)


def _crossing(n_heads: int, n_kv_heads: int, tp: int) -> list:
    """The positions whose query range neither lies inside one kv group nor
    covers whole kv groups, with their ranges."""
    group = n_heads // n_kv_heads
    bad = []
    for pos in range(tp):
        lo, hi = _q_range(n_heads, tp, pos)
        inside = hi == lo or lo // group == (hi - 1) // group
        whole = lo % group == 0 and hi % group == 0
        if not (inside or whole):
            bad.append((pos, lo, hi))
    return bad


def _split_error(n_heads: int, n_kv_heads: int, tp: int) -> str:
    pos, lo, hi = _crossing(n_heads, n_kv_heads, tp)[0]
    return (f"{n_heads} query heads over {n_kv_heads} kv heads do not split "
            f"over model={tp}: position {pos}'s query heads [{lo}, {hi}) "
            f"cross a kv group of {n_heads // n_kv_heads} unevenly")


def kv_split(n_heads: int, n_kv_heads: int, tp: int) -> bool:
    """Whether ``tp`` model positions can split ``n_heads`` query heads over
    ``n_kv_heads`` kv heads (:func:`query_head_range`): every position's
    query range lies inside one kv group (the positions whose ranges read
    a kv head share it) or covers whole kv groups, so each position's
    query group is uniform. A 40/8 split at ``tp`` 3 is not: position 0's
    heads ``[0, 14)`` read kv groups 0-2 unevenly."""
    if not n_heads:
        return True
    return not _crossing(n_heads, n_kv_heads, tp)


def kv_head_range(n_heads: int, n_kv_heads: int, tp: int, pos: int
                  ) -> tuple[int, int]:
    """The kv heads ``[lo // G, (hi - 1) // G + 1)`` that model position
    ``pos``'s query heads ``[lo, hi)`` (:func:`query_head_range`) read
    (query head ``h`` reads kv head ``h // G``): ``n_kv_heads / tp`` of
    them where they split, else the one kv head that the positions whose
    ranges read it share; empty for a position with no query heads.
    Raises ``ValueError`` where :func:`kv_split` is False."""
    lo, hi = query_head_range(n_heads, n_kv_heads, tp, pos)
    group = n_heads // n_kv_heads
    if hi == lo:
        return lo // group, lo // group
    return lo // group, (hi - 1) // group + 1


def _mixer_slice(name: str, shape: tuple[int, ...], dims: dict, tp: int,
                 pos: int) -> ModelSlice:
    """A Mamba2 mixer leaf's cut at model position ``pos`` of ``tp``:
    heads ``[pos H/tp, (pos+1) H/tp)`` and their ``d_inner`` channels.
    ``dims`` maps each mixer's path to its ``(d_inner, H)`` (read off its
    ``conv_w`` and ``A_log``). ``in_proj``'s columns ``[z | x | B | C |
    dt]`` give the heads' z, x and dt columns and every B and C column
    (one group: every head reads them); ``out_proj`` its heads' rows."""
    key = _key(name)
    di, heads = dims[_parent(name)]
    if heads % tp:
        raise ValueError(f"{name}: {heads} SSD heads do not split over "
                         f"model={tp}")
    h, c = heads // tp, di // tp
    last = len(shape) - 1
    if key == "in_proj":
        bc = 2 * di
        dt = shape[-1] - heads
        return ModelSlice(last, pos * c, (pos + 1) * c,
                          di + pos * c, di + (pos + 1) * c,
                          bc, dt, dt + pos * h, dt + (pos + 1) * h)
    if key == "out_proj":
        return ModelSlice(last - 1, pos * c, (pos + 1) * c)
    if key == "conv_w":
        return ModelSlice(last, pos * c, (pos + 1) * c)
    return ModelSlice(last, pos * h, (pos + 1) * h)


def _attention_slice(name: str, shape: tuple[int, ...], heads: tuple,
                     tp: int, pos: int) -> ModelSlice:
    """An attention leaf's cut at model position ``pos`` of ``tp``:
    ``wq``, ``bq`` and ``wo`` by the position's query heads, ``wk``,
    ``wv``, ``bk`` and ``bv`` by the kv heads they read. ``heads`` is the
    attention's ``(Hq, Hk, Dh)`` (read off its ``wq`` and ``wk``); ``wo``
    is ``(..., Hq, Dh, D)`` or, held 2-D, ``(Hq·Dh, D)`` (cut by rows)."""
    key = _key(name)
    n_q, n_kv, dh = heads
    if key in _KV:
        lo, hi = kv_head_range(n_q, n_kv, tp, pos)
        return ModelSlice(len(shape) - 2, lo, hi)
    lo, hi = query_head_range(n_q, n_kv, tp, pos)
    if key == "wo":
        if len(shape) == 2:
            return ModelSlice(0, lo * dh, hi * dh)
        return ModelSlice(len(shape) - 3, lo, hi)
    return ModelSlice(len(shape) - 2, lo, hi)


def model_slices(tree: PyTree, ctx: DistContext, pos: Optional[int] = None
                 ) -> PyTree:
    """For each leaf of ``tree`` (leaves need only ``.shape``), the
    :class:`ModelSlice` that model position ``pos`` (default: this rank's)
    computes with, or :data:`WHOLE` for a leaf every rank computes whole
    (every leaf when the mesh's ``model`` axis has one position; the
    embedding and the head where the vocab does not split). A Mamba2
    mixer's leaves are cut by SSD heads (:func:`_mixer_slice`), an
    attention's by whole heads (:func:`_attention_slice`: its query heads,
    :func:`query_head_range`, and the kv heads they read,
    :func:`kv_head_range`; positions that share a kv head each take it).
    Raises ``ValueError`` for a cut dim that does not split evenly, and
    for heads that :func:`kv_split` refuses."""
    tp = ctx.tp_size
    flat, treedef = flatten_with_path(tree)
    if tp == 1:
        return tree_unflatten(treedef, [WHOLE] * len(flat))
    if pos is None:
        pos = ctx.mesh.axis_position(ctx.tp)
    names = [keystr(path) for path, _ in flat]
    mixers: dict = {}
    for name, (_, leaf) in zip(names, flat):
        if _key(name) in ("conv_w", "A_log"):
            mixers.setdefault(_parent(name), {})[_key(name)] = \
                leaf.shape[-1]
    dims = {k: (v["conv_w"], v["A_log"]) for k, v in mixers.items()}
    kv = {_parent(name): leaf.shape[-2]
          for name, (_, leaf) in zip(names, flat) if _key(name) == "wk"}
    heads = {_parent(name): (leaf.shape[-2], kv.get(_parent(name),
                                                     leaf.shape[-2]),
                             leaf.shape[-1])
             for name, (_, leaf) in zip(names, flat)
             if _key(name) == "wq"}
    out = []
    for name, (_, leaf) in zip(names, flat):
        shape = tuple(leaf.shape)
        if _key(name) in _MIXER and _parent(name) in dims:
            out.append(_mixer_slice(name, shape, dims, tp, pos))
            continue
        if _key(name) in _KV + _Q and _parent(name) in heads:
            out.append(_attention_slice(name, shape, heads[_parent(name)],
                                        tp, pos))
            continue
        dim = _model_dim(name, shape, ctx)
        if dim is None or (_key(name) in _VOCAB and shape[dim] % tp):
            out.append(WHOLE)
            continue
        n = shape[dim]
        if n % tp:
            raise ValueError(f"{name}: dim {dim} of {shape} does not "
                             f"split over model={tp}")
        per = n // tp
        out.append(ModelSlice(dim, pos * per, (pos + 1) * per))
    return tree_unflatten(treedef, out)


def _take(x, s: ModelSlice):
    if not s:
        return x
    parts = [x.narrow(s[0], lo, hi - lo) for lo, hi in s.ranges]
    return parts[0] if len(parts) == 1 else torch.cat(parts, s[0])


def take_model_slices(tree: PyTree, slices: PyTree) -> PyTree:
    """``tree`` with each leaf cut to its slice (:func:`model_slices`): a
    view of one range, the concatenation of several (a gradient taken
    through either lands in the whole leaves')."""
    return tree_map(_take, tree, slices)


# ---------------------------------------------------------------------------
# The slice plan: the arena words of each model position's slices
# ---------------------------------------------------------------------------

class Box(tuple):
    """A strided box of words shared by the arena and the slice domain:
    ``(a0, s0, sizes, a_strides, s_strides)``. Its words are ``a0 +
    sum(i_k a_strides[k])`` in the arena and ``s0 + sum(i_k
    s_strides[k])`` in the slice domain, for every index ``i`` below
    ``sizes``, in the same (row-major) order on both sides; the last size
    is a run, contiguous on both sides (its strides 1)."""

    def __new__(cls, a0: int, s0: int, sizes, a_st, s_st):
        return super().__new__(cls, (int(a0), int(s0), tuple(sizes),
                                     tuple(a_st), tuple(s_st)))

    a0 = property(lambda self: self[0])
    s0 = property(lambda self: self[1])
    sizes = property(lambda self: self[2])
    a_st = property(lambda self: self[3])
    s_st = property(lambda self: self[4])

    @property
    def numel(self) -> int:
        return int(np.prod(self.sizes))

    @property
    def a_extent(self) -> int:
        """Words from the box's first arena word to past its last."""
        return sum((n - 1) * s for n, s in zip(self.sizes, self.a_st)) + 1

    def arena_view(self, buf: torch.Tensor, origin: int = 0) -> torch.Tensor:
        """The box's words of ``buf``, a contiguous 1-D buffer whose
        element 0 is arena word ``origin`` (a rank's span)."""
        return buf.as_strided(self.sizes, self.a_st,
                              buf.storage_offset() + self.a0 - origin)

    def slice_view(self, buf: torch.Tensor) -> torch.Tensor:
        """The box's values of ``buf``, a contiguous slice-domain buffer."""
        return buf.as_strided(self.sizes, self.s_st,
                              buf.storage_offset() + self.s0)


def _box(a0: int, s0: int, dims: list, run: int) -> Box:
    """The :class:`Box` of ``dims`` (``(count, a_stride, s_stride)``,
    outermost first) over a run of ``run`` words, its dims of one dropped
    and each dim that continues the one inside it on both sides merged."""
    dims = [d for d in dims if d[0] != 1]
    out: list = []
    for n, sa, ss in reversed(dims):
        if not out and sa == run and ss == run:
            run *= n
        elif out and sa == out[-1][0] * out[-1][1] \
                and ss == out[-1][0] * out[-1][2]:
            m = out.pop()
            out.append((m[0] * n, m[1], m[2]))
        else:
            out.append((n, sa, ss))
    out.reverse()
    return Box(a0, s0, [n for n, _, _ in out] + [run],
               [sa for _, sa, _ in out] + [1], [ss for _, _, ss in out] + [1])


def clip_box(b: Box, w0: int, w1: int) -> list:
    """The words of ``b`` inside the arena words ``[w0, w1)``, as boxes in
    the box's own order (at most two partial elements of each dim around
    the whole ones)."""
    lo = b.a0
    hi = lo + b.a_extent
    if hi <= w0 or lo >= w1:
        return []
    if lo >= w0 and hi <= w1:
        return [b]
    if len(b.sizes) == 1:
        a, z = max(lo, w0), min(hi, w1)
        return [Box(a, b.s0 + a - lo, (z - a,), (1,), (1,))]
    n, sa, ss = b.sizes[0], b.a_st[0], b.s_st[0]
    inner = Box(b.a0, b.s0, b.sizes[1:], b.a_st[1:], b.s_st[1:])
    ext = inner.a_extent

    def at(i: int) -> Box:
        return Box(b.a0 + i * sa, b.s0 + i * ss, inner.sizes, inner.a_st,
                   inner.s_st)
    first = min(max((w0 - lo) // sa, 0), n - 1)
    last = min(max((w1 - 1 - lo) // sa, 0), n - 1)
    i_lo = min(max(-(-(w0 - lo) // sa), 0), n)
    i_hi = max(i_lo, min((w1 - lo - ext) // sa + 1, n))
    out = []
    if first < i_lo:
        out += clip_box(at(first), w0, w1)
    if i_hi > i_lo:
        out.append(_box(b.a0 + i_lo * sa, b.s0 + i_lo * ss,
                        [(i_hi - i_lo, sa, ss)] + list(zip(
                            inner.sizes[:-1], inner.a_st[:-1],
                            inner.s_st[:-1])), inner.sizes[-1]))
    if last >= i_hi and not (last == first and first < i_lo):
        out += clip_box(at(last), w0, w1)
    return out


def _row_groups(r0: int, r1: int, br: int, seg: int, rw: int, srw: int,
                flat: bool) -> list:
    """Rows ``[r0, r1)`` of a leaf's ``(rows, rw)`` view as ``(row, dims)``
    groups, each a box's outer dims (``(count, a_stride, s_stride)``)
    from its first row: one group where the rows lie at a stride of ``rw``
    words (a one-block leaf, or blocks without padding), else a block's
    partial rows at either end and the whole blocks between (``seg``
    words a block)."""
    if flat:
        return [(r0, [(r1 - r0, rw, srw)])]
    out = []
    r = r0
    while r < r1:
        if r % br or r1 - r < br:
            e = min(r1, (r // br + 1) * br)
            out.append((r, [(e - r, rw, srw)]))
            r = e
        else:
            nb = (r1 - r) // br
            out.append((r, [(nb, seg, br * srw), (br, rw, srw)]))
            r += nb * br
    return out


def _leaf_boxes(layout, li: int, s: ModelSlice, base: int,
                row: Optional[int] = None) -> tuple[list, tuple]:
    """The boxes of leaf ``li``'s slice ``s`` (:data:`WHOLE`: the leaf) in
    an all-f32 arena ``layout``, its slice-domain values from ``base``
    (row-major in the slice's shape, several ranges concatenated as
    :func:`take_model_slices` takes them), and the slice's shape. Block
    ``b`` of the leaf holds rows ``[b br, (b+1) br)`` of its ``(rows,
    row_width)`` view. With ``row`` (a leaf stacked over its layers, the
    slice never cutting dim 0), the slice's part in that row alone: one
    layer's, its shape without the leading dim."""
    leaf = layout.partition.leaves[li]
    shape = tuple(leaf.shape)
    br = layout.partition.block_rows
    rows, rw = max(leaf.rows, 1), max(leaf.row_width, 1)
    off, seg = layout.leaf_offset[li], layout.seg_words[li]
    flat = leaf.n_blocks == 1 or seg == br * rw
    r0, r1 = (0, rows) if row is None else (row, row + 1)
    if row is not None and s and s[0] == 0:
        raise ValueError(f"leaf {li}: a layer's row of a slice cut along "
                         "dim 0")

    def word(r: int) -> int:
        return off + (r // br) * seg + (r % br) * rw

    if s and s[0] > 0:
        k = s[0]
        outer = int(np.prod(shape[1:k]))
        d = shape[k]
        inner = int(np.prod(shape[k + 1:]))
        width = sum(hi - lo for lo, hi in s.ranges)
        srw = outer * width * inner
        row_ranges = [(r0, r1, 0)]
        cols, b = [], 0
        for lo, hi in s.ranges:
            cols.append((lo * inner, b * inner,
                         [(outer, d * inner, width * inner)],
                         (hi - lo) * inner))
            b += hi - lo
        out_shape = shape[:k] + (width,) + shape[k + 1:]
    else:
        ranges = s.ranges if s else [(r0, r1)]
        srw = rw
        row_ranges, b = [], 0
        for lo, hi in ranges:
            row_ranges.append((lo, hi, b))
            b += hi - lo
        cols = [(0, 0, [], rw)]
        out_shape = (b,) + shape[1:] if shape else shape
    if row is not None:
        out_shape = out_shape[1:]
    boxes = []
    for lo, hi, sb in row_ranges:
        for r, rdims in _row_groups(lo, hi, br, seg, rw, srw, flat):
            for ca, cs, cdims, run in cols:
                boxes.append(_box(word(r) + ca,
                                  base + (sb + r - lo) * srw + cs,
                                  rdims + cdims, run))
    return boxes, out_shape


# the outer group: every leaf that no layer group holds (the embedding, the
# head, the final norms, a VLM's projector, the hybrid's shared block, the
# encoder-decoder's encoder), gathered for the whole step
OUTER = 0


class _GroupRef:
    """A layer group's place in :attr:`SlicePlan.skeleton`."""
    __slots__ = ("g",)

    def __init__(self, g: int):
        self.g = g


def _layer_groups(part, layers: tuple) -> tuple[list, list, PyTree]:
    """The groups of a partition's leaves: each group's ``(leaf, row)``
    entries (``row`` a stacked leaf's layer, else None) and its subtree's
    structure, group :data:`OUTER` first, then one group per layer of each
    ``(key, parts)`` of ``layers`` (a stacked subtree of the params, as a
    list of per-layer trees or as leaves stacked over their layers; each
    of ``parts`` a layer of its own, an interleaved model's ``dense`` and
    ``moe``), layer by layer; and the params' skeleton: the leaf indices
    outside the layers, a :class:`_GroupRef` in each layer's place, a
    stacked subtree turned into the list of its layers."""
    n = len(part.leaves)
    skel = tree_unflatten(part.treedef, list(range(n)))
    entries, treedefs = [None], [None]
    in_layer = np.zeros(n, bool)
    for key, parts in layers:
        node = skel[key]
        stacked = not isinstance(node, (list, tuple))
        count = (part.leaves[tree_leaves(node)[0]].shape[0] if stacked
                 else len(node))
        out = []
        for i in range(count):
            layer = node if stacked else node[i]
            refs = {}
            for p in parts or (None,):
                lis, td = tree_flatten(layer if p is None else layer[p])
                entries.append([(li, i if stacked else None) for li in lis])
                treedefs.append(td)
                in_layer[lis] = True
                refs[p] = _GroupRef(len(entries) - 1)
            out.append(refs if parts else refs[None])
        skel[key] = out
    entries[0] = [(li, None) for li in range(n) if not in_layer[li]]
    return entries, treedefs, skel


@dataclasses.dataclass
class _GroupCut:
    """One group's cut for every model position ``m``: its entries'
    boxes (arena words and group-local slice-domain values), whether each
    box lies in a leaf computed whole, the slices' shapes and offsets, the
    group's slice values, and each box's first and past-last arena word."""
    boxes: list
    whole: list
    shapes: list
    offsets: list
    values: list
    first: list
    end: list


class SlicePlan:
    """Which arena words each position of a mesh computes with, and who
    sends what to whom, for a sharded all-f32 arena ``layout`` (its spans
    one a position, :meth:`ArenaLayout.span`).

    Model position ``m`` (of ``tp``; one where ``ctx`` is None or its
    ``model`` axis has one position) computes with its slices of every
    leaf (:func:`model_slices`), held in a group's **slice domain**: the
    group's slices back to back in its order, each contiguous in its own
    shape (:meth:`group_values` in all), so a buffer of them decodes to
    slice-shaped leaves without a copy (:meth:`decode`). Each slice is a
    list of strided boxes of arena words (:func:`_leaf_boxes`), never a
    per-word index; with ``tp`` 1 every slice is the whole leaf, and the
    plan moves the whole arena's leaves.

    **Groups.** ``layers`` (``ModelOps.remat_layers`` where ``cfg.remat``)
    splits the leaves into groups, each with a slice domain of its own:
    one a layer the model runs through ``layers.layer_call`` (each
    ``(key, parts)``'s layers, ``parts`` each a group), in the order the
    model runs them, and :data:`OUTER` for every other leaf. A layer of
    leaves stacked over the layers (the reference's layout) is each
    stacked leaf's row of that layer: the same boxes cut to the row. Every
    method takes a ``group``; with no ``layers`` the plan has
    :data:`OUTER` alone, every leaf in leaf order. ``skeleton`` places the
    groups in the params tree (:meth:`model_tree`).

    The exchange (``MeshComm.slice_gather`` and ``slice_reduce``): owner
    ``q`` sends position ``p`` the words of its span that ``p``'s slices
    cover (:meth:`gather_boxes`: the group's boxes clipped to the span, in
    the same order on both sides); ``p`` sends owner ``q`` its gradient on the
    words it contributes (:meth:`reduce_boxes`): every data position, and
    of a model line the positions whose slice covers the word, where a
    leaf computed whole (:data:`WHOLE` while ``tp > 1``) counts at model
    position 0 alone. Built on the host once per (layout, mesh, ctx); each
    group's cut and each clipped list is made on first use and kept."""

    def __init__(self, layout, mesh, ctx: Optional[DistContext] = None,
                 layers: tuple = ()):
        n = int(np.asarray(mesh.devices).size)
        if layout.shards != n:
            raise ValueError(f"the layout has {layout.shards} shards, the "
                             f"mesh {n} positions")
        if not layout.uniform_f32:
            raise ValueError("a sharded arena holds an all-f32 model")
        self.layout = layout
        self.n, self.shard_words = n, layout.shard_words
        self.pos = mesh.position()
        tp = 1 if ctx is None else ctx.tp_size
        self.tp = tp
        if tp > 1:
            axis = mesh.axis_names.index(ctx.tp)
            self.model_of = tuple(int(c) for c in np.unravel_index(
                np.arange(n), mesh.devices.shape)[axis])
        else:
            self.model_of = (0,) * n
        part = layout.partition
        self.treedef = part.treedef
        shapes = tree_unflatten(part.treedef, [
            torch.empty(l.shape, device="meta") for l in part.leaves])
        self.slices = [tuple([WHOLE] * len(part.leaves) if tp == 1 else
                             [x for _, x in flatten_with_path(
                                 model_slices(shapes, ctx, pos=m))[0]])
                       for m in range(tp)]
        self.entries, self.group_treedefs, self.skeleton = _layer_groups(
            part, tuple(layers))
        self._outer_pos = {li: k for k, (li, _) in
                           enumerate(self.entries[OUTER])}
        self._cuts: dict = {}
        self._gather: dict = {}
        self._reduce: dict = {}
        self._owned: dict = {}

    @property
    def model(self) -> int:
        """This rank's model position."""
        return self.model_of[self.pos]

    @property
    def n_groups(self) -> int:
        """:data:`OUTER` and the layer groups."""
        return len(self.entries)

    def _cut(self, group: int) -> _GroupCut:
        got = self._cuts.get(group)
        if got is not None:
            return got
        got = _GroupCut([], [], [], [], [], [], [])
        for m in range(self.tp):
            boxes, whole, shp, offs, v = [], [], [], [], 0
            for li, row in self.entries[group]:
                s = self.slices[m][li]
                bx, out_shape = _leaf_boxes(self.layout, li, s, v, row)
                boxes += bx
                whole += [self.tp > 1 and not s] * len(bx)
                shp.append(out_shape)
                offs.append(v)
                v += int(np.prod(out_shape))
            first = np.asarray([b.a0 for b in boxes], np.int64)
            got.boxes.append(boxes)
            got.whole.append(np.asarray(whole, bool))
            got.shapes.append(tuple(shp))
            got.offsets.append(tuple(offs))
            got.values.append(v)
            got.first.append(first)
            got.end.append(first + np.asarray([b.a_extent for b in boxes],
                                              np.int64))
        self._cuts[group] = got
        return got

    def group_values(self, group: int, m: Optional[int] = None) -> int:
        """The slice values of ``group`` at model position ``m`` (default
        this rank's)."""
        return self._cut(group).values[self.model if m is None else m]

    def gather_boxes(self, q: int, m: int, group: int) -> list:
        """The words of owner ``q``'s span that model position ``m``'s
        slices (of ``group``) cover, as boxes (arena words and
        slice-domain values)."""
        key = (q, m, group)
        got = self._gather.get(key)
        if got is None:
            cut = self._cut(group)
            w0, w1 = q * self.shard_words, (q + 1) * self.shard_words
            hit = np.flatnonzero((cut.first[m] < w1) & (cut.end[m] > w0))
            got = [(c, bool(cut.whole[m][i])) for i in hit.tolist()
                   for c in clip_box(cut.boxes[m][i], w0, w1)]
            self._gather[key] = got
        return [b for b, _ in got]

    def reduce_boxes(self, q: int, m: int, group: int) -> list:
        """The words of owner ``q``'s span to which model position ``m``
        contributes its gradient (of ``group``): :meth:`gather_boxes`
        less the leaves computed whole, at a model position other than
        0."""
        key = (q, m, group)
        got = self._reduce.get(key)
        if got is None:
            self.gather_boxes(q, m, group)
            got = [b for b, w in self._gather[key] if m == 0 or not w]
            self._reduce[key] = got
        return got

    def gather_words(self, q: int, m: int, group: int) -> int:
        return sum(b.numel for b in self.gather_boxes(q, m, group))

    def reduce_words(self, q: int, m: int, group: int) -> int:
        return sum(b.numel for b in self.reduce_boxes(q, m, group))

    def max_count(self, reduce: bool, group: int) -> int:
        """The largest count any owner and position exchange (the same on
        every rank: it sets the all-to-all's rounds)."""
        words = self.reduce_words if reduce else self.gather_words
        return max((words(q, m, group) for q in range(self.n)
                    for m in range(self.tp)), default=0)

    def owned_words(self, q: int, group: int) -> int:
        """The words of owner ``q``'s span that ``group``'s leaves hold:
        what a reduce of the group lands there."""
        key = (q, group)
        got = self._owned.get(key)
        if got is None:
            w0, w1 = q * self.shard_words, (q + 1) * self.shard_words
            got = sum(c.numel for li, row in self.entries[group]
                      for b in _leaf_boxes(self.layout, li, WHOLE, 0,
                                           row)[0]
                      for c in clip_box(b, w0, w1))
            self._owned[key] = got
        return got

    def decode(self, buf: torch.Tensor, group: int,
               m: Optional[int] = None) -> list:
        """Model position ``m``'s (default this rank's) slices of
        ``group`` in its order, views of its slice-domain ``buf``."""
        m = self.model if m is None else m
        cut = self._cut(group)
        return [buf[o:o + int(np.prod(s))].view(s)
                for o, s in zip(cut.offsets[m], cut.shapes[m])]

    def model_tree(self, outer: list, layer) -> PyTree:
        """The params tree the model runs: the :data:`OUTER` group's
        leaves (``outer``, in its order) in their places and ``layer(g)``
        in the place of each layer group ``g`` (a stacked subtree becomes
        the list of its layers)."""
        return tree_map(lambda x: layer(x.g) if isinstance(x, _GroupRef)
                        else outer[self._outer_pos[x]], self.skeleton)

    def take(self, tree: PyTree, group: int, dtype=torch.float32
             ) -> torch.Tensor:
        """This rank's slices of ``group`` of the whole leaves of
        ``tree``, as a new slice-domain buffer of ``dtype``."""
        m = self.model
        leaves = tree_leaves(tree)
        out = torch.empty((self.group_values(group, m),), dtype=dtype,
                          device=leaves[0].device)
        for (li, row), y in zip(self.entries[group],
                                self.decode(out, group, m)):
            s = self.slices[m][li]
            if row is None:
                y.copy_(_take(leaves[li], s))
            else:
                y.copy_(_take(leaves[li][row], ModelSlice(s[0] - 1, *s[1:])
                              if s else s))
        return out

    def pack(self, out: torch.Tensor, grads: list, group: int
             ) -> torch.Tensor:
        """Each slice-shaped gradient of ``grads`` (``group``'s order)
        copied into the slice-domain ``out``, the list's entry set to None
        once copied (a caller holding no other reference frees it
        there)."""
        for li, y in enumerate(self.decode(out, group)):
            y.copy_(grads[li])
            grads[li] = None
        return out


# ---------------------------------------------------------------------------
# The serving state's cuts over the mesh
# ---------------------------------------------------------------------------

class StateSlice(tuple):
    """A serving-state leaf's cuts: a :class:`ModelSlice` a cut dim (the
    batch's data shard, then the model axis's heads or channels), taken in
    turn; empty for a leaf every rank holds whole. A tuple that the tree
    utilities keep as one leaf."""
    tree_leaf = True

    def __new__(cls, *cuts):
        return super().__new__(cls, cuts)


def _data_axes(ctx: DistContext) -> tuple[str, ...]:
    if ctx.mesh is None or ctx.dp_spec is None:
        return ()
    return tuple(a for a in ctx.dp if a in ctx.mesh.axis_names)


def batch_rows(n: int, ctx: Optional[DistContext], pos: Optional[int] = None
               ) -> tuple[int, int]:
    """The rows ``[lo, hi)`` of a global batch of ``n`` that this rank
    serves: its data shard, the batch's leading dim cut over the data axes
    as :func:`batch_partition_specs` places it (``pos``: the data shard,
    default this rank's, row-major over those axes); the whole batch
    without ``ctx``, or where ``ctx.batch_shardable`` is False. Raises
    ``ValueError`` for a batch that does not split."""
    axes = () if ctx is None else _data_axes(ctx)
    if not axes:
        return 0, n
    shape = [ctx.mesh.shape[a] for a in axes]
    shards = int(np.prod(shape))
    if n % shards:
        raise ValueError(f"a batch of {n} does not split over {shards} data "
                         "shards (make_dist_ctx(..., batch_shardable=False) "
                         "serves it whole on every rank)")
    if pos is None:
        coords = ctx.mesh.coords()
        pos = int(np.ravel_multi_index(
            [coords[ctx.mesh.axis_names.index(a)] for a in axes], shape))
    per = n // shards
    return pos * per, (pos + 1) * per


# the serving state's leaves (their trailing keys): (their rank, the dim the
# model axis cuts): the caches' and the scales' kv heads, the SSM state's
# SSD heads, the conv state's d_inner channels (the rank's heads')
_STATE_MODEL_DIM = {"k": (5, 3), "v": (5, 3), "cross_k": (5, 3),
                    "cross_v": (5, 3), "k_scale": (4, 3), "v_scale": (4, 3),
                    "h": (5, 2), "conv": (4, 3)}
# of those, the leaves cut by kv heads
_KV_STATE = ("k", "v", "cross_k", "cross_v", "k_scale", "v_scale")


def state_slices(state: PyTree, ctx: DistContext,
                 pos: Optional[int] = None, data_pos: Optional[int] = None,
                 heads: Optional[int] = None) -> PyTree:
    """For each leaf of a serving state (a KV cache, an SSM state, the
    hybrid's both; leaves need only ``.shape``, the global shapes), the
    :class:`StateSlice` that model position ``pos`` and data shard
    ``data_pos`` (default: this rank's) hold, as the reference's
    ``_state_spec_for_leaf`` places them: the batch dim (dim 1) over the
    data axes (:func:`batch_rows`), and over the model axis ``k``, ``v``,
    ``cross_k`` and ``cross_v`` by kv heads, ``k_scale`` and ``v_scale``
    by kv heads, the SSM ``h`` by SSD heads and ``conv`` by ``d_inner``
    channels; ``kpos`` and ``pos`` whole. Given the ``heads`` query heads
    (``cfg.n_heads``), the kv-head leaves hold the kv heads the rank's
    query heads read (:func:`kv_head_range`: the even cut where the heads
    split, else the positions that share a kv head each hold it, and a
    position with no query heads none; the reference cuts ``head_dim``
    there). Without ``heads``, a dim that does not split evenly raises
    ``ValueError``, as does a split :func:`kv_split` refuses."""
    tp = ctx.tp_size
    if tp > 1 and pos is None:
        pos = ctx.mesh.axis_position(ctx.tp)
    flat, treedef = flatten_with_path(state)
    out = []
    for path, leaf in flat:
        name, shape = keystr(path), tuple(leaf.shape)
        rule = _STATE_MODEL_DIM.get(_key(name))
        if rule is None or rule[0] != len(shape):
            out.append(StateSlice())
            continue
        cuts = []
        lo, hi = batch_rows(shape[1], ctx, data_pos)
        if hi - lo != shape[1]:
            cuts.append(ModelSlice(1, lo, hi))
        dim = rule[1]
        if tp > 1:
            if heads and _key(name) in _KV_STATE:
                cuts.append(ModelSlice(dim, *kv_head_range(
                    heads, shape[dim], tp, pos)))
            elif shape[dim] % tp == 0:
                per = shape[dim] // tp
                cuts.append(ModelSlice(dim, pos * per, (pos + 1) * per))
            else:
                raise ValueError(f"{name}: dim {dim} of {shape} does not "
                                 f"split over model={tp}")
        out.append(StateSlice(*cuts))
    return tree_unflatten(treedef, out)


def vocab_ctx(cfg, ctx: Optional[DistContext]) -> Optional[DistContext]:
    """``ctx`` where ``cfg``'s vocab splits over its ``model`` axis, else
    None: the embedding, the head and the loss then run their one-device
    route on every rank (:func:`model_slices` leaves them whole)."""
    if ctx is None or cfg.vocab % ctx.tp_size:
        return None
    return ctx


def check_tensor_parallel(cfg, tp: int) -> None:
    """Raise ``ValueError`` naming ``cfg`` when its heads, experts,
    feed-forward widths or SSD heads do not split over ``tp`` model
    positions. Query heads split into whole-head ranges as even as the
    count allows (:func:`query_head_range`) and kv heads into those the
    ranges read (:func:`kv_head_range`), wherever every range lies inside
    one kv group or covers whole kv groups (:func:`kv_split`); the error
    names the heads and the first range that does not. A vocab that does
    not split is computed whole (:func:`vocab_ctx`)."""
    dims = {"n_experts": cfg.n_experts, "d_ff": cfg.d_ff,
            "d_ff_dense": cfg.d_ff_dense,
            "ssm_heads": cfg.ssm_heads if cfg.ssm_state else 0}
    bad = {k: v for k, v in dims.items() if v % tp}
    if not kv_split(cfg.n_heads, cfg.n_kv_heads, tp):
        bad.update(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads)
        why = "; " + _split_error(cfg.n_heads, cfg.n_kv_heads, tp)
    else:
        why = ""
    if bad:
        raise ValueError(f"{cfg.name}: {bad} do not split over model={tp} "
                         "(tensor parallelism needs every one to divide"
                         f"{why})")
