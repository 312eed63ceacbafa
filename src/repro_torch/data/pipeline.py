"""The LM data pipeline, single device.

The port of ``repro.data.pipeline.ShardedLMDataset`` without the mesh: a
deterministic synthetic token stream drawn host-side from
``np.random.default_rng(seed)`` in the reference's order, so both packages
see the same tokens, then put on the device. On a real cluster the
generator would be per-host file readers; the interface (``__iter__`` of
batches) is what the trainer consumes.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device


class ShardedLMDataset:
    """Batches of ``{"tokens", "labels"}`` int32 (batch, seq) tensors on
    ``device`` (``cuda`` unless asked otherwise); ``labels`` is ``tokens``
    shifted by one."""

    def __init__(self, cfg: ModelConfig, batch: int, seq: int,
                 seed: int = 0, device: DeviceLike = None):
        self.cfg, self.batch, self.seq = cfg, batch, seq
        self.device = resolve_device(device)
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
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in batch.items()}

    def __iter__(self) -> Iterator[dict]:
        while True:
            yield self.next_batch()
