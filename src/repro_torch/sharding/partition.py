"""Initial block homes over the fabric's logical devices.

The port of ``repro.sharding.partition.block_device_homes`` only; the
mesh shardings of that module belong to ROADMAP item 15.
"""
from __future__ import annotations

import numpy as np


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
