"""Checkpoint/recovery policy configuration (paper §4).

A copy of ``repro.core.policy`` (which has no JAX in it), so that the
port imports nothing of the JAX package.

``CheckpointPolicy`` is the single object users pass to the trainer to turn
SCAR on. It encodes the paper's knobs:

- ``fraction r``       — fraction of parameter blocks saved per partial
                         checkpoint (paper §4.2; r = 1 is the traditional
                         full checkpoint).
- ``full_interval C``  — the *budget-equivalent* full-checkpoint interval;
                         partial checkpoints fire every ``max(1, round(rC))``
                         iterations so bytes/iteration match the full
                         strategy (paper §4.2).
- ``strategy``         — PRIORITY (largest distance since last save),
                         ROUND_ROBIN, RANDOM (paper §5.4 baselines).
- ``recovery``         — PARTIAL (paper §4.1) or FULL (traditional).
- ``norm``             — name of the block norm used for priority scoring
                         ("l2" default; "scaled_tv" for distribution-valued
                         parameters, paper Appendix C).
"""
from __future__ import annotations

import dataclasses
import enum


class SelectionStrategy(str, enum.Enum):
    PRIORITY = "priority"
    ROUND_ROBIN = "round"
    RANDOM = "random"


class RecoveryMode(str, enum.Enum):
    PARTIAL = "partial"
    FULL = "full"


@dataclasses.dataclass(frozen=True)
class CheckpointPolicy:
    fraction: float = 1.0          # r
    full_interval: int = 4         # C (iterations between full-budget ckpts)
    strategy: SelectionStrategy = SelectionStrategy.PRIORITY
    recovery: RecoveryMode = RecoveryMode.PARTIAL
    norm: str = "l2"
    block_rows: int = 128          # block granularity
    persist_dir: str | None = None  # on-disk mirror (None = in-memory only)
    async_persist: bool = True     # paper §4.3: resume as soon as cache updated

    def __post_init__(self):
        if not (0.0 < self.fraction <= 1.0):
            raise ValueError(f"fraction r must be in (0, 1], got {self.fraction}")
        if self.full_interval < 1:
            raise ValueError("full_interval C must be >= 1")
        if self.block_rows < 1:
            raise ValueError("block_rows must be >= 1")

    @property
    def partial_interval(self) -> int:
        """rC rounded to at least one iteration (paper §4.2)."""
        return max(1, round(self.fraction * self.full_interval))

    @classmethod
    def traditional(cls, interval: int = 4) -> "CheckpointPolicy":
        """The baseline the paper compares against: full checkpoints every C
        iterations, full recovery."""
        return cls(fraction=1.0, full_interval=interval,
                   strategy=SelectionStrategy.ROUND_ROBIN,
                   recovery=RecoveryMode.FULL)

    @classmethod
    def scar(cls, fraction: float = 0.125, interval: int = 8,
             norm: str = "l2") -> "CheckpointPolicy":
        """The paper's headline configuration: prioritized 1/8th checkpoints
        at 8× frequency + partial recovery (§5.4)."""
        return cls(fraction=fraction, full_interval=interval,
                   strategy=SelectionStrategy.PRIORITY,
                   recovery=RecoveryMode.PARTIAL, norm=norm)
