"""Run-summary rendering over a :class:`~repro_torch.telemetry.recorder.Recorder`.

``run_report`` folds the recorder's three streams (events, scopes/metrics,
ledger) into one structured summary dict; ``format_report`` renders it as
text: the single place that answers "what did this run's failures
actually cost, in bound and in wall-clock?". The port of
``repro.telemetry.report``, the same summary and text.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np

# canonical tier order for the recovery table
_TIER_ORDER = ("SURVIVOR", "PEER_REPLICA", "PARITY", "RUNNING_CKPT", "DISK")


def _tier_table(events: list[dict]) -> dict:
    """Per-tier totals over every ``recovery`` event: blocks recovered and
    the perturbation energy (‖δ′‖² share) each tier applied."""
    blocks: dict[str, int] = {}
    sq: dict[str, float] = {}
    n = lost = 0
    applied = 0.0
    for ev in events:
        if ev.get("kind") != "recovery":
            continue
        n += 1
        lost += int(ev.get("lost_blocks") or 0)
        applied += float(ev.get("applied_sq") or 0.0)
        for t, k in (ev.get("tier_counts") or {}).items():
            blocks[t] = blocks.get(t, 0) + int(k)
        for t, v in (ev.get("tier_sq") or {}).items():
            sq[t] = sq.get(t, 0.0) + float(v)
    order = [t for t in _TIER_ORDER if t in blocks or t in sq]
    order += [t for t in blocks if t not in order]
    return {"n_recoveries": n, "lost_blocks": lost,
            "applied_sq_total": applied,
            "per_tier": {t: {"blocks": blocks.get(t, 0),
                             "sq": sq.get(t, 0.0)} for t in order}}


def _bytes_breakdown(rec: Any) -> dict:
    """Bytes-moved breakdown from the registered component scopes plus the
    compact events' reclaim totals."""
    scopes = getattr(rec, "scopes", {}) or {}

    def _get(scope: str, key: str) -> int:
        return int(sum(v.get(key, 0) for name, v in scopes.items()
                       if name == scope or name.startswith(scope + "#")))

    compacted = sum(int(ev.get("reclaimed") or 0)
                    for ev in (getattr(rec, "events", []) or [])
                    if ev.get("kind") == "compact")
    # arena_padding_ratio is a gauge, not a counter: take the max across
    # fabric scope instances rather than summing (one fabric in practice)
    padding = max((float(v.get("arena_padding_ratio", 0.0))
                   for name, v in scopes.items()
                   if name == "fabric" or name.startswith("fabric#")),
                  default=0.0)
    return {"maintain": _get("fabric", "maintain_bytes_moved"),
            "save": _get("controller", "save_bytes_moved"),
            "mirrored": _get("controller", "bytes_mirrored"),
            "compact_reclaimed": compacted,
            "arena_padding_ratio": padding}


def _interconnect(rec: Any) -> dict:
    """ICI-vs-DCN split of the anti-affine replica transfer: cumulative
    totals from the fabric scope plus per-maintain averages from the
    ``maintain`` events' ``ici_bytes``/``dcn_bytes`` fields. On a real
    topology these are the link classes a block migration would cross, so
    the split is the input a Chameleon-style migration cost model needs
    (zero on an unmeshed fabric, where the replica never leaves the
    host)."""
    scopes = getattr(rec, "scopes", {}) or {}

    def _get(scope: str, key: str) -> int:
        return int(sum(v.get(key, 0) for name, v in scopes.items()
                       if name == scope or name.startswith(scope + "#")))

    per = [(int(ev.get("ici_bytes") or 0), int(ev.get("dcn_bytes") or 0))
           for ev in (getattr(rec, "events", []) or [])
           if ev.get("kind") == "maintain"
           and ("ici_bytes" in ev or "dcn_bytes" in ev)]
    n = len(per)
    return {"ici": _get("fabric", "ici_bytes_moved"),
            "dcn": _get("fabric", "dcn_bytes_moved"),
            "maintains": n,
            "ici_per_maintain": (sum(p[0] for p in per) / n) if n else 0.0,
            "dcn_per_maintain": (sum(p[1] for p in per) / n) if n else 0.0}


def _overhead(rec: Any) -> dict:
    """p50/p95/max of the maintenance-overhead histogram (clean steps
    only — the loops exclude failure/heal steps at observe time)."""
    hist = (getattr(rec, "histograms", {}) or {}).get(
        "train/overhead_seconds")
    if hist is None or not hist.samples:
        # classic runners book per-phase spans instead of a histogram —
        # fall back to the maintain-span durations
        tracer = getattr(rec, "tracer", None)
        samples = tracer.durations("maintain") if tracer is not None else []
        if not samples:
            return {"count": 0, "mean": 0.0, "p50": 0.0, "p95": 0.0,
                    "max": 0.0}
        a = np.asarray(samples)
        return {"count": int(a.size), "mean": float(a.mean()),
                "p50": float(np.percentile(a, 50)),
                "p95": float(np.percentile(a, 95)),
                "max": float(a.max())}
    return hist.summary()


def run_report(rec: Any, horizon: Optional[int] = None) -> dict:
    """The unified run summary. ``rec`` is a Recorder (a NullRecorder
    yields an empty-but-well-formed report). ``horizon`` optionally fixes
    the dense delta-series length for the joint cumulative bound."""
    events = list(getattr(rec, "events", []) or [])
    kinds: dict[str, int] = {}
    for ev in events:
        kinds[ev.get("kind", "?")] = kinds.get(ev.get("kind", "?"), 0) + 1
    ledger = getattr(rec, "ledger", None)
    out = {
        "events": {"total": len(events), "by_kind": kinds},
        "recovery": _tier_table(events),
        "overhead_seconds": _overhead(rec),
        "bytes": _bytes_breakdown(rec),
        "interconnect": _interconnect(rec),
        "ledger": (ledger.summary() if ledger is not None else None),
    }
    if ledger is not None and horizon is not None:
        out["ledger"]["cumulative_bound"] = \
            ledger.cumulative_bound(horizon)
    return out


def format_report(report: dict) -> str:
    """Render a report dict as a human-readable text block."""
    lines = []
    ev = report["events"]
    kinds = ", ".join(f"{k}={n}" for k, n in sorted(ev["by_kind"].items()))
    lines.append(f"telemetry: {ev['total']} events ({kinds or 'none'})")

    r = report["recovery"]
    if r["n_recoveries"]:
        lines.append(f"recoveries: {r['n_recoveries']} events, "
                     f"{r['lost_blocks']} blocks lost, "
                     f"applied ||d'||^2={r['applied_sq_total']:.3e}")
        sq_hdr = "||d'||^2"
        lines.append(f"  {'tier':<14}{'blocks':>8}  {sq_hdr:>12}")
        for t, row in r["per_tier"].items():
            lines.append(f"  {t:<14}{row['blocks']:>8}  {row['sq']:>12.3e}")
    else:
        lines.append("recoveries: none")

    o = report["overhead_seconds"]
    if o["count"]:
        lines.append(
            f"maintenance overhead: p50={o['p50'] * 1e3:.2f}ms "
            f"p95={o['p95'] * 1e3:.2f}ms max={o['max'] * 1e3:.2f}ms "
            f"({o['count']} clean steps)")

    b = report["bytes"]
    lines.append(f"bytes moved: maintain={b['maintain']:,} "
                 f"save={b['save']:,} mirrored={b['mirrored']:,} "
                 f"compact_reclaimed={b['compact_reclaimed']:,}")
    if b.get("arena_padding_ratio"):
        lines.append(
            f"arena padding ratio: {b['arena_padding_ratio']:.4f} "
            "(pad words / payload words, tail-packed layout)")

    ic = report.get("interconnect") or {}
    if ic.get("ici") or ic.get("dcn"):
        lines.append(
            f"replica interconnect: ici={ic['ici']:,} dcn={ic['dcn']:,} "
            f"(avg {ic['ici_per_maintain']:,.0f}/{ic['dcn_per_maintain']:,.0f}"
            f" per maintain over {ic['maintains']})")

    led = report.get("ledger")
    if led and led["n_events"]:
        owed = led["iterations_owed_total"]
        joint = led["cumulative_bound"]
        lines.append(
            "iterations owed to faults: "
            + (f"{owed:.2f} (sum of per-event Thm-3.2 bounds), "
               if owed is not None else "unpriced (set c/x0_err), ")
            + (f"joint bound {joint:.2f}" if joint is not None
               else "joint bound n/a"))
        for e in led["entries"]:
            bound = (f"{e['bound']:.3f}" if e["bound"] is not None
                     else "n/a")
            tiers = ",".join(f"{t}:{n}" for t, n in e["source_tiers"].items())
            lines.append(f"  step {e['step']}: lost {e['lost_blocks']} "
                         f"blocks via [{tiers}] ||d'||={e['delta_norm']:.3e}"
                         f" -> bound {bound}")
    return "\n".join(lines)
