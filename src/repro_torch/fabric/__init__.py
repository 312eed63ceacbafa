"""Tiered checkpoint fabric: failure domains, peer replicas, XOR parity
and an elastic placement engine (the port of ``repro.fabric``, on its
synchronous arena path).

The paper's SCAR recovers every lost block from the in-memory running
checkpoint. Real failures are correlated (a host or rack takes every block
homed there), and cheaper tiers exist: anti-affine peer replicas and XOR
parity groups recover *live* values at zero perturbation. The fabric layers
those tiers above the running checkpoint and resolves each lost block to
the cheapest surviving one.
"""
from repro_torch.fabric.availability import summarize_availability
from repro_torch.fabric.domains import FailureDomainMap, FailureEvent
from repro_torch.fabric.fabric import CheckpointFabric, FabricConfig
from repro_torch.fabric.parity import ParityCodec
from repro_torch.fabric.placement import (ClusterView,
                                          anti_affine_replica_homes,
                                          rebalance_homes, rehome_blocks,
                                          stripe_parity_groups)
from repro_torch.fabric.replica import ReplicaSet
from repro_torch.fabric.tiers import RecoveryTier, TieredRecovery, TierPlan

__all__ = ["FailureDomainMap", "FailureEvent", "CheckpointFabric",
           "FabricConfig", "ParityCodec", "ReplicaSet", "RecoveryTier",
           "TieredRecovery", "TierPlan", "ClusterView",
           "anti_affine_replica_homes", "rebalance_homes", "rehome_blocks",
           "stripe_parity_groups", "summarize_availability"]
