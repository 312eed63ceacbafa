"""Unified telemetry: metrics registry + event bus, span tracing, and the
perturbation-cost ledger.

Quick tour::

    from repro_torch.telemetry import Recorder, run_report, format_report

    rec = Recorder(out_dir="telemetry_out")        # events.jsonl streams
    loop = TrainLoop(cfg, loop_cfg=TrainLoopConfig(
        policy=pol, fabric=FabricConfig(), mtbf={"host": 50.0},
        recorder=rec))
    state = loop.run(loop.init_state(), batches, 200)
    rec.ledger.set_rates(c, x0_err)                # price the faults
    print(format_report(run_report(rec)))
    rec.close()                                    # trace.json + metrics.json

The default everywhere is :data:`NULL_RECORDER` — all emit points are
no-ops and the hot path is unchanged. The port of ``repro.telemetry``.
"""
from repro_torch.telemetry.ledger import LedgerEntry, PerturbationLedger
from repro_torch.telemetry.recorder import (EVENT_SCHEMA, NULL_RECORDER,
                                            Counter, Gauge, Histogram,
                                            NullRecorder, Recorder,
                                            read_events_jsonl)
from repro_torch.telemetry.report import format_report, run_report
from repro_torch.telemetry.spans import SpanRecord, SpanTracer

__all__ = ["Recorder", "NullRecorder", "NULL_RECORDER", "Counter", "Gauge",
           "Histogram", "EVENT_SCHEMA", "read_events_jsonl",
           "PerturbationLedger", "LedgerEntry", "SpanTracer", "SpanRecord",
           "run_report", "format_report"]
