"""Metrics registry + event bus for fault-tolerance runs.

The port of ``repro.telemetry.recorder``, the same classes and schema.

One :class:`Recorder` per run unifies the three telemetry streams the
fabric/controller/loops previously kept as scattered ad-hoc state:

- **scopes** — the components' ``stats`` dicts (``FTController.stats``,
  ``CheckpointFabric.stats``, …) registered by name with the recorder, so
  one ``metrics()`` call snapshots every counter in the run under a shared
  schema. The dicts stay plain dicts: registration is by reference, the
  hot-path mutation cost is unchanged, and components keep working when no
  recorder is attached.
- **typed metrics** — :class:`Counter` / :class:`Gauge` /
  :class:`Histogram` for quantities that want more than a scalar (the
  maintenance-overhead distribution feeds ``overhead_summary``'s
  p50/p95/max from a histogram, not a re-derived mean).
- **structured events** — ``event(kind, **fields)`` appends one record to
  the in-memory log AND one line to an append-only JSONL file
  (``events.jsonl`` under ``out_dir``). Kinds and their fields are listed
  in :data:`EVENT_SCHEMA`.

The default everywhere is the :data:`NULL_RECORDER` singleton — every
method is a no-op returning shared singletons, so instrumented hot paths
cost one attribute check and no allocation.

A :class:`Recorder` also owns a :class:`~repro_torch.telemetry.spans.SpanTracer`
(``span("maintain")`` context manager, Chrome-trace export) and a
:class:`~repro_torch.telemetry.ledger.PerturbationLedger` fed by
``record_recovery`` — the Thm-3.2/4.1 iteration-cost bound of every
recovery event becomes a first-class observable of the run.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Optional

import numpy as np

# event kinds with their documented payload fields (informative — extra
# fields are allowed and preserved; the JSONL round-trip is schema-free).
# ``seq``/``ts``/``kind`` are stamped on every event by the recorder.
EVENT_SCHEMA: dict[str, tuple[str, ...]] = {
    "failure":  ("step", "lost_blocks", "failed_devices", "domain_kind",
                 "domain_index"),
    "recovery": ("step", "lost_blocks", "tier_counts", "tier_sq",
                 "applied_sq", "failed_devices"),
    "maintain": ("step", "mode", "bytes_moved", "replica", "parity"),
    "save":     ("step", "blocks", "bytes_moved", "seconds", "mode"),
    "mirror":   ("step", "bytes", "segments", "background"),
    "store_write_failed": ("step", "segment", "host", "path", "error"),
    "store_write_retried": ("step", "segment", "host", "path", "error",
                            "attempt", "delay_seconds"),
    "tier_fallback": ("step", "group", "lost_members", "unavailable",
                      "strength", "fresh"),
    "silent_error_detected": ("step", "group", "error_kind", "member",
                              "block", "row", "localized", "corrected"),
    "compact":  ("reclaimed", "rekeyed"),
    "rehome":   ("step", "rehomed_blocks", "alive_devices", "alive_hosts",
                 "parity_groups"),
    "heal":     ("step", "domain_kind", "domain_index", "healed_devices",
                 "rebalanced_blocks"),
}


def _jsonable(v):
    """Coerce numpy scalars and arrays and 0-d tensors into JSON-serializable values."""
    if isinstance(v, dict):
        return {k: _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, np.ndarray):
        return v.tolist()
    if hasattr(v, "item") and getattr(v, "ndim", None) == 0:
        return v.item()
    return v


# -- typed metrics -----------------------------------------------------------


class Counter:
    """Monotonic counter."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        self.value += v


class Gauge:
    """Last-value-wins scalar."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Raw-sample histogram (run lengths here are small enough that
    keeping the samples beats committing to bucket edges up front)."""

    __slots__ = ("samples",)

    def __init__(self) -> None:
        self.samples: list[float] = []

    def observe(self, v: float) -> None:
        self.samples.append(float(v))

    def percentile(self, q: float) -> float:
        if not self.samples:
            return 0.0
        return float(np.percentile(np.asarray(self.samples), q))

    def summary(self) -> dict[str, float]:
        if not self.samples:
            return {"count": 0, "mean": 0.0, "p50": 0.0, "p95": 0.0,
                    "max": 0.0}
        a = np.asarray(self.samples)
        return {"count": int(a.size), "mean": float(a.mean()),
                "p50": float(np.percentile(a, 50)),
                "p95": float(np.percentile(a, 95)),
                "max": float(a.max())}


class _NullMetric:
    """Shared do-nothing stand-in for every typed metric."""

    __slots__ = ()
    value = 0.0
    samples: list[float] = []

    def inc(self, v: float = 1.0) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass

    def percentile(self, q: float) -> float:
        return 0.0

    def summary(self) -> dict[str, float]:
        return {"count": 0, "mean": 0.0, "p50": 0.0, "p95": 0.0, "max": 0.0}


_NULL_METRIC = _NullMetric()


class _NullSpan:
    """Reusable no-op context manager (one shared instance per process)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


# -- recorders ---------------------------------------------------------------


class NullRecorder:
    """The default: every instrumented emit point is a no-op.

    Components are written against this interface; the real
    :class:`Recorder` subclasses it. ``enabled`` lets hot paths skip
    building event payloads entirely.
    """

    enabled = False
    ledger = None
    tracer = None
    out_dir: Optional[str] = None

    def scope(self, name: str, stats: Optional[dict] = None) -> dict:
        """Return (and, when enabled, register) a component stats dict."""
        return stats if stats is not None else {}

    def counter(self, name: str) -> Counter:
        return _NULL_METRIC  # type: ignore[return-value]

    def gauge(self, name: str) -> Gauge:
        return _NULL_METRIC  # type: ignore[return-value]

    def histogram(self, name: str) -> Histogram:
        return _NULL_METRIC  # type: ignore[return-value]

    def adopt_histogram(self, name: str, hist: Histogram) -> None:
        pass

    def event(self, kind: str, **fields: Any) -> None:
        pass

    def span(self, name: str, fence: Any = None, **attrs: Any):
        return _NULL_SPAN

    def record_recovery(self, step: Optional[int], lost_blocks: int,
                        tier_counts: Optional[dict], applied_sq: float,
                        **extra: Any) -> None:
        pass

    def metrics(self) -> dict:
        return {}

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


NULL_RECORDER = NullRecorder()


class Recorder(NullRecorder):
    """The real thing: registry + JSONL event bus + tracer + ledger.

    ``out_dir`` (optional) is created on first use; events stream to
    ``events.jsonl`` as they happen (append-only — a crash loses at most
    the event being written), and :meth:`close` writes ``trace.json``
    (Chrome ``trace_event`` format, loadable in Perfetto) and
    ``metrics.json`` (the full registry snapshot + report).
    """

    enabled = True

    def __init__(self, out_dir: Optional[str] = None, *,
                 ledger: Optional[Any] = None,
                 clock=time.perf_counter) -> None:
        from repro_torch.telemetry.ledger import PerturbationLedger
        from repro_torch.telemetry.spans import SpanTracer
        self.out_dir = out_dir
        self._clock = clock
        self._t0 = clock()
        self.scopes: dict[str, dict] = {}
        self.counters: dict[str, Counter] = {}
        self.gauges: dict[str, Gauge] = {}
        self.histograms: dict[str, Histogram] = {}
        self.events: list[dict] = []
        self.tracer = SpanTracer(clock=clock)
        self.ledger = ledger if ledger is not None else PerturbationLedger()
        self._lock = threading.Lock()
        self._jsonl = None
        if out_dir is not None:
            os.makedirs(out_dir, exist_ok=True)
            self._jsonl = open(os.path.join(out_dir, "events.jsonl"), "a")

    # -- registry -----------------------------------------------------------

    def scope(self, name: str, stats: Optional[dict] = None) -> dict:
        """Register a component's stats dict by reference under ``name``
        (unique-suffixed on collision) and return it — the component keeps
        mutating its own plain dict; ``metrics()`` sees it live."""
        d = stats if stats is not None else {}
        key, n = name, 2
        while key in self.scopes and self.scopes[key] is not d:
            key, n = f"{name}#{n}", n + 1
        self.scopes[key] = d
        return d

    def counter(self, name: str) -> Counter:
        return self.counters.setdefault(name, Counter())

    def gauge(self, name: str) -> Gauge:
        return self.gauges.setdefault(name, Gauge())

    def histogram(self, name: str) -> Histogram:
        return self.histograms.setdefault(name, Histogram())

    def adopt_histogram(self, name: str, hist: Histogram) -> None:
        """Register a histogram a component already owns (e.g. the train
        loop's overhead distribution, which exists recorder or not)."""
        self.histograms[name] = hist

    # -- events -------------------------------------------------------------

    def event(self, kind: str, **fields: Any) -> None:
        rec = {"seq": 0, "ts": self._clock() - self._t0, "kind": kind}
        rec.update({k: _jsonable(v) for k, v in fields.items()})
        with self._lock:
            rec["seq"] = len(self.events)
            self.events.append(rec)
            if self._jsonl is not None:
                self._jsonl.write(json.dumps(rec) + "\n")
                self._jsonl.flush()

    # -- spans --------------------------------------------------------------

    def span(self, name: str, fence: Any = None, **attrs: Any):
        return self.tracer.span(name, fence=fence, **attrs)

    # -- ledger -------------------------------------------------------------

    def record_recovery(self, step: Optional[int], lost_blocks: int,
                        tier_counts: Optional[dict], applied_sq: float,
                        **extra: Any) -> None:
        """One recovery event: ledger entry (Thm-3.2/4.1 bound accounting)
        + a structured ``recovery`` event on the bus. Extra fields reach
        the ledger entry too (``LedgerEntry.extra``) — an async-mode
        recovery carries ``recovered_epoch``/``staleness`` so the entry
        records *which* epoch was actually restored, not just how far the
        restored values sat from the live ones."""
        self.ledger.record(step=step, lost_blocks=lost_blocks,
                           tier_counts=tier_counts, applied_sq=applied_sq,
                           **extra)
        self.event("recovery", step=step, lost_blocks=lost_blocks,
                   tier_counts=tier_counts, applied_sq=applied_sq, **extra)

    # -- snapshots ----------------------------------------------------------

    def metrics(self) -> dict:
        """Deep snapshot of every scope + typed metric (safe to mutate)."""
        return _jsonable({
            "scopes": {k: dict(v) for k, v in self.scopes.items()},
            "counters": {k: c.value for k, c in self.counters.items()},
            "gauges": {k: g.value for k, g in self.gauges.items()},
            "histograms": {k: h.summary()
                           for k, h in self.histograms.items()},
        })

    def flush(self) -> None:
        if self._jsonl is not None:
            self._jsonl.flush()

    def close(self) -> None:
        """Flush the JSONL stream and, with an ``out_dir``, write the
        Chrome trace + metrics/report snapshot artifacts."""
        self.flush()
        if self.out_dir is not None:
            self.tracer.write_chrome_trace(
                os.path.join(self.out_dir, "trace.json"))
            from repro_torch.telemetry.report import run_report
            snap = {"metrics": self.metrics(), "report": run_report(self)}
            tmp = os.path.join(self.out_dir, "metrics.json.tmp")
            with open(tmp, "w") as f:
                json.dump(_jsonable(snap), f, indent=2)
            os.replace(tmp, os.path.join(self.out_dir, "metrics.json"))
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None


def read_events_jsonl(path: str) -> list[dict]:
    """Load an ``events.jsonl`` back into event dicts (analysis helper —
    the round trip through this is covered by tests)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out
