"""The LM data pipeline.

The port of ``repro.data.pipeline.ShardedLMDataset``: a deterministic
synthetic token stream drawn host-side from ``np.random.default_rng(seed)``
in the reference's order, so both packages see the same tokens, then put
on the device. On a mesh (``ctx``) every rank draws the same global batch
and keeps its slice. Where the forward is model-parallel (a mesh whose
``model`` axis has more than one position) the batch dim splits over the
data positions only, in row-major order of the other axes, and the ranks
of one model line keep the same rows; otherwise
every mesh position, in row-major order, is a data-parallel rank and
takes its own rows. The batch is a :class:`MeshBatch`,
which keeps the global batch's host arrays, so a trainer can re-slice it
for a shrunk mesh. On a real cluster the generator would be per-host file
readers; the interface (``__iter__`` of batches) is what the trainer
consumes.
"""
from __future__ import annotations

from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device


class MeshBatch(dict):
    """A rank's slice of a global batch (the dict's tensors) and the global
    batch itself as host arrays (``global_rows``)."""
    global_rows: dict

    @property
    def global_batch(self) -> int:
        return int(next(iter(self.global_rows.values())).shape[0])


def data_shard(mesh, model_parallel: bool) -> tuple[int, Optional[int]]:
    """The number of batch shards of ``mesh`` and this rank's (None
    outside it): every position, or with ``model_parallel`` the positions
    of the axes other than ``model``."""
    pos = mesh.position()
    if not model_parallel or "model" not in mesh.axis_names:
        return mesh.size, pos
    a = mesh.axis_names.index("model")
    n = mesh.size // mesh.devices.shape[a]
    if pos is None:
        return n, None
    coords = list(mesh.coords())
    shape = list(mesh.devices.shape)
    del coords[a], shape[a]
    return n, int(np.ravel_multi_index(coords, shape)) if shape else 0


def slice_batch(rows: dict, mesh, device,
                model_parallel: bool = False) -> Optional[MeshBatch]:
    """This rank's slice of the global batch ``rows`` (host arrays) over
    ``mesh``'s batch shards (:func:`data_shard`), on ``device``; None for
    a rank outside the mesh."""
    n, pos = data_shard(mesh, model_parallel)
    if pos is None:
        return None
    b = next(iter(rows.values())).shape[0]
    if b % n:
        raise ValueError(f"a batch of {b} does not split over "
                         f"{n} batch shards of {mesh}")
    per = b // n
    out = MeshBatch({k: torch.from_numpy(np.ascontiguousarray(
        v[pos * per:(pos + 1) * per])).to(device) for k, v in rows.items()})
    out.global_rows = rows
    return out


def model_parallel(cfg: ModelConfig, ctx) -> bool:
    """Whether ``cfg``'s forward splits over ``ctx``'s ``model`` axis: a
    family whose ``train_loss`` is tensor-parallel, on a mesh whose
    ``model`` axis has more than one position."""
    if ctx is None or ctx.mesh is None or ctx.tp_size == 1:
        return False
    from repro_torch.models import get_model
    return get_model(cfg).tensor_parallel


class ShardedLMDataset:
    """Batches of ``{"tokens", "labels"}`` int32 (batch, seq) tensors on
    ``device`` (``cuda`` unless asked otherwise); ``labels`` is ``tokens``
    shifted by one. With ``ctx`` (a
    :class:`~repro_torch.sharding.partition.DistContext` with a mesh)
    each batch is the rank's slice (:func:`slice_batch`)."""

    def __init__(self, cfg: ModelConfig, batch: int, seq: int,
                 seed: int = 0, device: DeviceLike = None, ctx=None):
        self.cfg, self.batch, self.seq = cfg, batch, seq
        self.device = resolve_device(device)
        self.ctx = ctx
        self._rng = np.random.default_rng(seed)
        self._step = 0

    def next_batch(self) -> dict:
        """The next batch, drawn as the reference draws, on the device."""
        cfg = self.cfg
        tokens = self._rng.integers(0, cfg.vocab,
                                    (self.batch, self.seq + 1), dtype=np.int32)
        batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
        if cfg.family == "vlm":
            batch["patches"] = self._rng.normal(
                0, 1, (self.batch, cfg.n_patches, cfg.vit_dim)
            ).astype(np.float32)
        if cfg.family == "audio":
            batch["frames"] = self._rng.normal(
                0, 1, (self.batch, cfg.enc_seq, cfg.d_model)
            ).astype(np.float32)
        self._step += 1
        if self.ctx is not None and self.ctx.mesh is not None:
            return slice_batch(batch, self.ctx.mesh, self.device,
                               model_parallel(self.cfg, self.ctx))
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in batch.items()}

    def __iter__(self) -> Iterator[dict]:
        while True:
            yield self.next_batch()
