"""Persistent checkpoint storage (the paper's CephFS/NFS role)."""
from repro_torch.checkpoint_io.store import ShardedCheckpointStore

__all__ = ["ShardedCheckpointStore"]
