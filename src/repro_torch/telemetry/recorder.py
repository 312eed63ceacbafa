"""The no-op telemetry surface that the controller and the runners call.

The port of ``repro.telemetry.recorder.NullRecorder``: every instrumented
emit point is a no-op, and ``enabled`` lets hot paths skip building event
payloads. The full ``Recorder`` (registry, event bus, tracer, ledger) is
still to be ported.
"""
from __future__ import annotations

import contextlib
from typing import Any, Optional


class _NullMetric:
    def observe(self, value: float) -> None:
        pass


_NULL_METRIC = _NullMetric()


class NullRecorder:
    enabled = False

    def scope(self, name: str, stats: Optional[dict] = None) -> dict:
        """Return the component's stats dict (a real recorder registers it)."""
        return stats if stats is not None else {}

    def histogram(self, name: str) -> _NullMetric:
        return _NULL_METRIC

    def event(self, kind: str, **fields: Any) -> None:
        pass

    def span(self, name: str, fence: Any = None, **attrs: Any):
        return contextlib.nullcontext()

    def record_recovery(self, step: Optional[int], lost_blocks: int,
                        tier_counts: Optional[dict], applied_sq: float,
                        **extra: Any) -> None:
        pass


NULL_RECORDER = NullRecorder()
