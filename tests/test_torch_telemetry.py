"""The port's telemetry (``repro_torch.telemetry``) against the reference's
(``repro.telemetry``): the cases of ``tests/test_telemetry.py`` on the
port, and, where both packages can be fed the same records, their outputs
compared.

- the recorder and its JSONL event bus: round trip, schema, scopes by
  reference, events from several threads;
- spans: nesting, the Chrome trace, a fence that runs before the end
  timestamp (a callable, or tensors whose CUDA device is waited for);
- the ledger: bounds equal to ``core/iteration_cost`` bit for bit and to
  the reference's ledger on the same entries;
- ``record_recovery``, the null recorder's shared singletons, histogram
  percentiles, ``run_report``/``format_report`` equal to the reference's on
  the same records (a shared fake clock makes the timestamps equal);
- the instrumented components: the controller and fabric emit the
  reference's kinds on a classic run and a trainer run, and stay on
  ``NULL_RECORDER`` by default.
"""
import itertools
import json
import time

import numpy as np
import pytest
import torch

from repro import telemetry as jt
from repro.core.iteration_cost import iteration_cost_bound as j_icb
from repro_torch.configs import get_config
from repro_torch.core.blocks import partition_pytree
from repro_torch.core.controller import FTController
from repro_torch.core.iteration_cost import (iteration_cost_bound,
                                             single_perturbation_bound)
from repro_torch.core.policy import CheckpointPolicy
from repro_torch.data import ShardedLMDataset
from repro_torch.fabric import CheckpointFabric, FabricConfig
from repro_torch.models.classic import make_model
from repro_torch.telemetry import (EVENT_SCHEMA, NULL_RECORDER, Histogram,
                                   NullRecorder, PerturbationLedger,
                                   Recorder, SpanTracer, format_report,
                                   read_events_jsonl, run_report)
from repro_torch.training import TrainLoop, TrainLoopConfig
from repro_torch.training.classic_runner import (run_with_failure,
                                                 run_with_trace)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while these tests run (several workers share a
    few cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qp():
    return make_model("qp", device="cpu")


def _fake_clock():
    c = itertools.count()
    return lambda: float(next(c)) * 0.5


# ---------------------------------------------------------------------------
# recorder + event bus
# ---------------------------------------------------------------------------

def test_events_jsonl_round_trip(tmp_path):
    out = tmp_path / "telemetry"
    rec = Recorder(out_dir=str(out))
    rec.event("failure", step=3, lost_blocks=np.int64(4), failed_devices=2)
    rec.event("maintain", step=np.int32(3), mode="arena",
              bytes_moved=1024, replica=True, parity=True)
    rec.event("save", step=torch.tensor(4), blocks=2,
              bytes_moved=np.float64(8.0), seconds=0.01, mode="arena")
    rec.close()
    back = read_events_jsonl(str(out / "events.jsonl"))
    assert back == rec.events
    assert [e["seq"] for e in back] == [0, 1, 2]
    assert all(isinstance(e["ts"], float) for e in back)
    assert back[0]["lost_blocks"] == 4 and back[1]["mode"] == "arena"
    assert back[2]["step"] == 4
    json.dumps(back)


def test_event_bus_equals_reference_on_the_same_events(tmp_path):
    """The same emits under one fake clock give the same records and the
    same JSONL lines in both packages; the schema is the reference's."""
    assert EVENT_SCHEMA == jt.EVENT_SCHEMA
    recs = [Recorder(out_dir=str(tmp_path / "t"), clock=_fake_clock()),
            jt.Recorder(out_dir=str(tmp_path / "j"), clock=_fake_clock())]
    for rec in recs:
        rec.event("failure", step=3, lost_blocks=np.int64(4),
                  failed_devices=2)
        rec.event("rehome", step=3, rehomed_blocks=7, alive_devices=6,
                  alive_hosts=3, parity_groups=np.int32(5))
        rec.close()
    assert recs[0].events == recs[1].events
    assert (tmp_path / "t" / "events.jsonl").read_text() \
        == (tmp_path / "j" / "events.jsonl").read_text()


def test_event_kinds_documented():
    rec = Recorder()
    run_with_failure(_qp(), CheckpointPolicy(fraction=0.5, full_interval=4),
                     fail_iter=6, fail_fraction=0.5, max_iters=12,
                     fabric=FabricConfig(n_devices=8), recorder=rec,
                     device="cpu")
    kinds = {e["kind"] for e in rec.events}
    assert kinds >= {"failure", "recovery", "maintain", "save"}
    assert kinds <= set(EVENT_SCHEMA)


def test_scope_registration_by_reference():
    rec = Recorder()
    stats = rec.scope("fabric", {"x": 0})
    stats["x"] = 7
    assert rec.metrics()["scopes"]["fabric"]["x"] == 7
    other = rec.scope("fabric", {"x": 1})
    assert other is not stats
    assert set(rec.scopes) == {"fabric", "fabric#2"}
    snap = rec.metrics()
    stats["x"] = 99
    assert snap["scopes"]["fabric"]["x"] == 7


def test_background_thread_events_are_serialized(tmp_path):
    import threading
    rec = Recorder(out_dir=str(tmp_path / "t"))

    def emit(k):
        for i in range(50):
            rec.event("mirror", step=i, bytes=k, segments=1,
                      background=True)

    threads = [threading.Thread(target=emit, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    rec.close()
    back = read_events_jsonl(str(tmp_path / "t" / "events.jsonl"))
    assert len(back) == 200
    assert sorted(e["seq"] for e in back) == list(range(200))


# ---------------------------------------------------------------------------
# span tracer + Chrome trace export
# ---------------------------------------------------------------------------

def test_spans_nest_and_export_chrome_trace(tmp_path):
    tracer = SpanTracer()
    with tracer.span("outer", step=1):
        with tracer.span("inner"):
            time.sleep(0.002)
    doc = tracer.chrome_trace()
    assert set(doc) >= {"traceEvents", "displayTimeUnit"}
    evs = {e["name"]: e for e in doc["traceEvents"]}
    assert set(evs) == {"outer", "inner"}
    for e in evs.values():
        assert e["ph"] == "X" and e["dur"] >= 0 and e["ts"] >= 0
        assert isinstance(e["pid"], int) and isinstance(e["tid"], int)
    outer, inner = evs["outer"], evs["inner"]
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1e-6
    assert outer["args"] == {"step": 1}
    path = tracer.write_chrome_trace(str(tmp_path / "trace.json"))
    with open(path) as f:
        assert len(json.load(f)["traceEvents"]) == 2


def test_chrome_trace_equals_reference_under_one_clock():
    docs = []
    for tracer in (SpanTracer(clock=_fake_clock()),
                   jt.SpanTracer(clock=_fake_clock())):
        with tracer.span("train_step", step=1):
            with tracer.span("maintain", step=1, mode=None):
                pass
        tracer.record("maintain", 0.25, 0.75, deferred=True)
        doc = tracer.chrome_trace()
        for e in doc["traceEvents"]:
            e.pop("pid"), e.pop("tid")
        doc["otherData"].pop("source")
        docs.append(doc)
    assert docs[0] == docs[1]


def test_span_fence_runs_before_end_timestamp():
    tracer = SpanTracer()
    with tracer.span("maintain", fence=lambda: time.sleep(0.02)):
        pass
    (dur,) = tracer.durations("maintain")
    assert dur >= 0.02


def test_span_fence_accepts_tensors():
    """A tensor or a tree of tensors is a fence: their CUDA devices are
    waited for (none on the CPU)."""
    tracer = SpanTracer()
    x = torch.ones(8)
    with tracer.span("maintain", fence=x * 2):
        pass
    with tracer.span("maintain", fence={"a": x, "b": [x, 3]}):
        pass
    assert len(tracer.durations("maintain")) == 2
    assert tracer.intervals("maintain")[0][0] <= tracer.intervals(
        "maintain")[1][0]


# ---------------------------------------------------------------------------
# perturbation ledger
# ---------------------------------------------------------------------------

def _ledger_entries(led):
    led.record(step=5, lost_blocks=3, tier_counts={"RUNNING_CKPT": 3},
               applied_sq=0.25)
    led.record(step=12, lost_blocks=1, tier_counts={"PEER_REPLICA": 1},
               applied_sq=0.0)
    led.record(step=12, lost_blocks=2, tier_counts={"PARITY": 2,
                                                    "RUNNING_CKPT": 0},
               applied_sq=1e-3)
    return led


def test_ledger_bounds_bit_match_iteration_cost():
    led = _ledger_entries(PerturbationLedger(c=0.9, x0_err=10.0))
    for e in led.entries:
        assert e.bound == single_perturbation_bound(
            e.delta_norm, 0.9, T=e.step, x0_err=10.0)
    assert led.cumulative_bound(20) == float(iteration_cost_bound(
        led.delta_series(20), 0.9, 10.0))
    dense = led.delta_series(20)
    assert len(dense) == 21 and dense[5] == pytest.approx(0.5)
    owed = led.iterations_owed()
    assert owed == sorted(owed)


def test_ledger_equals_reference_ledger():
    t = _ledger_entries(PerturbationLedger(c=0.9, x0_err=10.0))
    j = _ledger_entries(jt.PerturbationLedger(c=0.9, x0_err=10.0))
    assert [e.bound for e in t.entries] == [e.bound for e in j.entries]
    assert t.summary() == j.summary()
    assert t.cumulative_bound(20) == j.cumulative_bound(20) == float(
        j_icb(j.delta_series(20), 0.9, 10.0))


def test_ledger_backfills_bounds_on_set_rates():
    led = PerturbationLedger()
    e = led.record(step=7, lost_blocks=2, tier_counts=None, applied_sq=4.0)
    assert e.bound is None and led.cumulative_bound() is None
    led.set_rates(0.8, 5.0)
    assert e.bound == single_perturbation_bound(2.0, 0.8, T=7, x0_err=5.0)
    assert led.summary()["iterations_owed_total"] == pytest.approx(e.bound)


def test_record_recovery_feeds_ledger_and_bus():
    rec = Recorder()
    rec.record_recovery(step=9, lost_blocks=4,
                        tier_counts={"PARITY": 4}, applied_sq=1.0)
    (entry,) = rec.ledger.entries
    assert entry.delta_norm == 1.0 and entry.source_tiers == {"PARITY": 4}
    (ev,) = rec.events
    assert ev["kind"] == "recovery" and ev["tier_counts"] == {"PARITY": 4}


# ---------------------------------------------------------------------------
# NullRecorder: the zero-overhead default
# ---------------------------------------------------------------------------

def test_null_recorder_is_allocation_free_singletons():
    assert NULL_RECORDER.enabled is False
    assert isinstance(NULL_RECORDER, NullRecorder)
    assert NULL_RECORDER.span("a") is NULL_RECORDER.span("b")
    assert NULL_RECORDER.histogram("x") is NULL_RECORDER.counter("y")
    assert NULL_RECORDER.gauge("z") is NULL_RECORDER.counter("y")
    d = {"k": 1}
    assert NULL_RECORDER.scope("s", d) is d
    with NULL_RECORDER.span("noop", fence=lambda: 1 / 0):
        pass
    NULL_RECORDER.event("anything", x=1)
    NULL_RECORDER.record_recovery(step=1, lost_blocks=1,
                                  tier_counts=None, applied_sq=0.0)
    NULL_RECORDER.adopt_histogram("h", Histogram())
    NULL_RECORDER.flush()
    NULL_RECORDER.close()
    assert NULL_RECORDER.metrics() == {}


def test_components_default_to_null_recorder():
    m = _qp()
    ctl = FTController(m.init(torch.Generator().manual_seed(1)),
                       CheckpointPolicy(fraction=0.5, full_interval=4),
                       fabric=FabricConfig(n_devices=8), device="cpu")
    assert ctl.recorder is NULL_RECORDER
    assert ctl.fabric.recorder is NULL_RECORDER
    assert isinstance(ctl.stats, dict) and isinstance(ctl.fabric.stats, dict)


def test_fabric_attach_recorder_rebinds_stats():
    p = _qp().init(torch.Generator().manual_seed(1))
    part = partition_pytree(p, 16)
    fab = CheckpointFabric(part, FabricConfig(n_devices=8))
    stats = fab.stats
    rec = Recorder()
    fab.attach_recorder(rec)
    assert fab.recorder is rec
    assert rec.scopes["fabric"] is stats
    assert rec.histograms["fabric/fence_seconds"] is fab.fence_hist
    fab.attach_recorder(Recorder())
    assert fab.recorder is rec
    fab2 = CheckpointFabric(part, FabricConfig(n_devices=8))
    fab2.attach_recorder(NULL_RECORDER)
    assert fab2.recorder is NULL_RECORDER
    # a controller handed a prebuilt fabric attaches its recorder
    rec3 = Recorder()
    ctl = FTController(p, CheckpointPolicy(fraction=0.5, full_interval=4),
                       fabric=fab2, recorder=rec3, device="cpu")
    assert ctl.fabric.recorder is rec3


# ---------------------------------------------------------------------------
# instrumented runs, snapshots, report
# ---------------------------------------------------------------------------

def test_run_with_failure_emits_and_prices(tmp_path):
    rec = Recorder(out_dir=str(tmp_path / "t"))
    res = run_with_failure(_qp(), CheckpointPolicy(fraction=0.5,
                                                   full_interval=4),
                           fail_iter=8, fail_fraction=0.5, max_iters=16,
                           fabric=FabricConfig(n_devices=8), recorder=rec,
                           device="cpu")
    kinds = {e["kind"] for e in rec.events}
    assert {"failure", "recovery", "maintain", "save"} <= kinds
    (entry,) = rec.ledger.entries
    assert entry.applied_sq == pytest.approx(
        float(res["recovery"]["applied_sq"]))
    assert entry.lost_blocks == int(res["recovery"]["lost_blocks"])
    rec.ledger.set_rates(0.9, 10.0)
    assert entry.bound == single_perturbation_bound(
        entry.delta_norm, 0.9, T=8, x0_err=10.0)
    # the maintain spans are fenced and one per maintained step
    assert len(rec.tracer.durations("maintain")) == len(
        [e for e in rec.events if e["kind"] == "maintain"])
    rec.close()
    for name in ("events.jsonl", "trace.json", "metrics.json"):
        assert (tmp_path / "t" / name).exists()
    report = run_report(rec, horizon=16)
    assert report["recovery"]["n_recoveries"] == 1
    assert report["ledger"]["cumulative_bound"] == float(
        iteration_cost_bound(rec.ledger.delta_series(16), 0.9, 10.0))
    assert "iterations owed" in format_report(report)


def test_classic_runner_results_are_snapshots():
    rec = Recorder()
    res = run_with_failure(_qp(), CheckpointPolicy(fraction=0.5,
                                                   full_interval=4),
                           fail_iter=6, fail_fraction=0.5, max_iters=12,
                           fabric=FabricConfig(n_devices=8), recorder=rec,
                           device="cpu")
    live_ctl = rec.scopes["controller"]
    live_fab = rec.scopes["fabric"]
    assert res["controller_stats"]["saves"] == live_ctl["saves"]
    live_ctl["saves"] += 100
    live_fab["maintain_bytes_moved"] += 10 ** 9
    live_ctl["events"].append({"poison": True})
    assert res["controller_stats"]["saves"] == live_ctl["saves"] - 100
    assert res["fabric_stats"]["maintain_bytes_moved"] \
        == live_fab["maintain_bytes_moved"] - 10 ** 9
    assert all("poison" not in e for e in res["controller_stats"]["events"])


def test_run_with_trace_emits_rehome_and_heal():
    rec = Recorder()
    res = run_with_trace(_qp(), CheckpointPolicy(fraction=0.5,
                                                 full_interval=4),
                         fabric=FabricConfig(n_devices=8, elastic=True),
                         max_iters=20, mtbf={"device": 8.0}, heal_after=3,
                         recorder=rec, device="cpu")
    kinds = {e["kind"] for e in rec.events}
    assert "rehome" in kinds and kinds <= set(EVENT_SCHEMA)
    live = rec.scopes["controller"]
    n_before = len(res["controller_stats"]["events"])
    live["events"].append({"poison": True})
    assert len(res["controller_stats"]["events"]) == n_before


def test_report_on_null_recorder_is_well_formed():
    report = run_report(NULL_RECORDER)
    assert report["events"]["total"] == 0
    assert report["ledger"] is None
    assert "telemetry: 0 events" in format_report(report)
    assert format_report(report) == jt.format_report(jt.run_report(
        jt.NULL_RECORDER))


def _fill(rec, stats):
    rec.scope("fabric", dict(stats["fabric"]))
    rec.scope("controller", dict(stats["controller"]))
    for v in (0.01, 0.02, 0.05):
        rec.histogram("train/overhead_seconds").observe(v)
    rec.event("maintain", step=1, mode="arena", bytes_moved=4096,
              ici_bytes=0, dcn_bytes=0, replica=True, parity=True)
    rec.event("failure", step=2, lost_blocks=5, failed_devices=2)
    rec.record_recovery(step=2, lost_blocks=5,
                        tier_counts={"PEER_REPLICA": 3, "PARITY": 1,
                                     "RUNNING_CKPT": 1},
                        applied_sq=0.5,
                        tier_sq={"PEER_REPLICA": 0.0, "PARITY": 0.0,
                                 "RUNNING_CKPT": 0.5})
    rec.event("compact", reclaimed=128, rekeyed=1)
    rec.ledger.set_rates(0.9, 10.0)


def test_format_report_equals_reference_on_the_same_records():
    stats = {"fabric": {"maintain_bytes_moved": 8192, "ici_bytes_moved": 0,
                        "dcn_bytes_moved": 0, "arena_padding_ratio": 0.25},
             "controller": {"save_bytes_moved": 1024, "saves": 2}}
    t = Recorder(clock=_fake_clock())
    j = jt.Recorder(clock=_fake_clock())
    _fill(t, stats)
    _fill(j, stats)
    assert run_report(t, horizon=8) == jt.run_report(j, horizon=8)
    assert format_report(run_report(t, horizon=8)) \
        == jt.format_report(jt.run_report(j, horizon=8))
    assert t.metrics() == j.metrics()


def test_histogram_summary_percentiles():
    vals = [1.0, 2.0, 3.0, 4.0, 100.0]
    h, hj = Histogram(), jt.Histogram()
    for v in vals:
        h.observe(v)
        hj.observe(v)
    s = h.summary()
    assert s["count"] == 5 and s["max"] == 100.0 and s["p50"] == 3.0
    assert s["p95"] == pytest.approx(float(np.percentile(vals, 95)))
    assert s == hj.summary()
    assert h.percentile(75) == hj.percentile(75)


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

def test_trainer_emits_and_registers(tmp_path):
    cfg = get_config("qwen2-1.5b", reduced=True)
    rec = Recorder(out_dir=str(tmp_path / "t"))
    loop = TrainLoop(cfg, loop_cfg=TrainLoopConfig(
        policy=CheckpointPolicy.scar(fraction=0.25, interval=2),
        fabric=FabricConfig(), fail_schedule=[(3, "host", 0)],
        recorder=rec), device="cpu")
    state = loop.init_state()
    loop.run(state, iter(ShardedLMDataset(cfg, 2, 32, device="cpu")), 4)
    kinds = {e["kind"] for e in rec.events}
    assert {"maintain", "save", "failure", "recovery"} <= kinds
    assert kinds <= set(EVENT_SCHEMA)
    assert {e["mode"] for e in rec.events if e["kind"] == "maintain"} \
        == {"arena_resident"}
    for name in ("train_step", "maintain", "save", "recovery"):
        assert rec.tracer.durations(name)
    assert rec.histograms["train/overhead_seconds"] \
        is loop._overhead_hist
    assert rec.histograms["train/overhead_seconds"].summary()["count"] == 3
    assert "fabric/fence_seconds" in rec.histograms
    assert len(rec.ledger.entries) == 1
    avail = loop.availability_summary()
    assert avail["telemetry"]["recoveries_priced"] == 1
    rec.close()
    assert (tmp_path / "t" / "trace.json").exists()


def test_trainer_heal_on_default_fabric_emits_heal_event():
    """``heal_after`` on the default (non-elastic) fabric with a recorder
    attached: the heal is emitted under the schema's field names."""
    cfg = get_config("qwen2-1.5b", reduced=True)
    rec = Recorder()
    loop = TrainLoop(cfg, loop_cfg=TrainLoopConfig(
        policy=CheckpointPolicy.scar(fraction=0.25, interval=2),
        fabric=FabricConfig(), fail_schedule=[(2, "host", 1)], heal_after=2,
        recorder=rec), device="cpu")
    loop.run(loop.init_state(), iter(ShardedLMDataset(cfg, 2, 32,
                                                      device="cpu")), 5)
    heals = [e for e in rec.events if e["kind"] == "heal"]
    assert len(heals) == 1
    assert heals[0]["domain_kind"] == "host" and heals[0]["domain_index"] == 1
    assert heals[0]["step"] == 4 and heals[0]["healed_devices"] > 0
    assert "heals" in loop.metrics[3]
    assert loop.controller.fabric.stats["heals"] == 1


def test_trainer_defaults_to_null_recorder():
    cfg = get_config("mamba2-370m", reduced=True)
    loop = TrainLoop(cfg, loop_cfg=TrainLoopConfig(
        policy=CheckpointPolicy.scar(fraction=0.25, interval=2),
        fabric=FabricConfig()), device="cpu")
    loop.run(loop.init_state(), iter(ShardedLMDataset(cfg, 2, 32,
                                                      device="cpu")), 2)
    assert loop.recorder is NULL_RECORDER
    assert loop.controller.fabric.recorder is NULL_RECORDER
    assert loop.overhead_summary()["overhead_clean_steps"] == 2
