"""Span tracing with device-sync fencing and Chrome-trace export.

The port of ``repro.telemetry.spans``. ``SpanTracer.span("maintain")`` is
a nestable context manager that records wall-clock begin/end per phase.
PyTorch returns from a CUDA launch before the card runs it, so a phase's
Python exit time routinely precedes the device work it launched; the
``fence`` argument closes that gap: on exit, before the end timestamp is
taken, the tracer either calls the fence (a callable like
``fabric.block_until_maintained``) or, given a tensor or a tree of
tensors, waits for the CUDA devices they lie on (on the CPU there is
nothing to wait for). The recorded duration is then the phase's *device*
work, not its dispatch.

Export is the Chrome ``trace_event`` JSON format (complete events,
``"ph": "X"``, microsecond timestamps), loadable in Perfetto
(https://ui.perfetto.dev) or ``chrome://tracing`` — nesting renders
automatically for properly contained events on one track.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import threading
import time
from typing import Any


def _run_fence(fence: Any) -> None:
    """Synchronize on a phase's device work: call it, or wait for the CUDA
    devices of its tensors."""
    if callable(fence):
        fence()
        return
    import torch
    from repro_torch.utils.tree import tree_leaves
    devices = {x.device for x in tree_leaves(fence)
               if isinstance(x, torch.Tensor) and x.device.type == "cuda"}
    for d in devices:
        torch.cuda.synchronize(d)


@dataclasses.dataclass
class SpanRecord:
    name: str
    t0: float          # seconds since tracer start
    t1: float
    depth: int         # nesting depth at entry (0 = top level)
    tid: int           # recording thread id
    args: dict

    @property
    def duration(self) -> float:
        return self.t1 - self.t0


class SpanTracer:
    """Collects :class:`SpanRecord`s; one instance per run/Recorder."""

    def __init__(self, clock=time.perf_counter) -> None:
        self._clock = clock
        self._t0 = clock()
        self._lock = threading.Lock()
        self._local = threading.local()
        self.spans: list[SpanRecord] = []

    def _depth(self) -> int:
        return getattr(self._local, "depth", 0)

    @contextlib.contextmanager
    def span(self, name: str, fence: Any = None, **args: Any):
        depth = self._depth()
        self._local.depth = depth + 1
        t0 = self._clock() - self._t0
        try:
            yield
        finally:
            if fence is not None:
                _run_fence(fence)
            t1 = self._clock() - self._t0
            self._local.depth = depth
            rec = SpanRecord(name=name, t0=t0, t1=t1, depth=depth,
                             tid=threading.get_ident(), args=dict(args))
            with self._lock:
                self.spans.append(rec)

    def now(self) -> float:
        """Current tracer-relative timestamp (seconds since tracer start)
        — the time base :meth:`record` expects."""
        return self._clock() - self._t0

    def record(self, name: str, t0: float, t1: float,
               **args: Any) -> SpanRecord:
        """Record a span retroactively from explicit tracer-relative
        timestamps (see :meth:`now`). This is how deferred device work
        gets an honest interval: an async maintenance sweep is *dispatched*
        inside one step but only *fenced* when its outputs are consumed —
        the span covering [dispatch, fence] can't be a context manager, it
        is closed after the fact by whoever takes the fence. Depth is 0
        (deferred spans overlap the top-level step spans by design, which
        is exactly what the Chrome trace should show)."""
        rec = SpanRecord(name=name, t0=float(t0), t1=float(t1), depth=0,
                         tid=threading.get_ident(), args=dict(args))
        with self._lock:
            self.spans.append(rec)
        return rec

    # -- analysis -----------------------------------------------------------

    def durations(self, name: str) -> list[float]:
        """All recorded durations (seconds) of spans named ``name``."""
        return [s.duration for s in self.spans if s.name == name]

    def intervals(self, name: str) -> list[tuple[float, float]]:
        """All recorded (t0, t1) intervals of spans named ``name`` —
        overlap assertions (does ``maintain`` run under ``train_step``?)
        read these directly instead of re-parsing the Chrome export."""
        return [(s.t0, s.t1) for s in self.spans if s.name == name]

    # -- export -------------------------------------------------------------

    def chrome_trace(self) -> dict:
        """The ``trace_event`` document: one complete ("X") event per
        span. Timestamps/durations are microseconds per the format."""
        events = []
        for s in sorted(self.spans, key=lambda s: s.t0):
            args = {k: v for k, v in s.args.items() if v is not None}
            events.append({
                "name": s.name, "cat": "repro", "ph": "X",
                "ts": round(s.t0 * 1e6, 3),
                "dur": round(s.duration * 1e6, 3),
                "pid": os.getpid(), "tid": s.tid,
                "args": args,
            })
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": {"source": "repro_torch.telemetry"}}

    def write_chrome_trace(self, path: str) -> str:
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.chrome_trace(), f)
        os.replace(tmp, path)
        return path
