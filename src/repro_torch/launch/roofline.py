"""The roofline of the dry run's steps, on a card's figures.

The port of ``repro.launch.roofline``. Three terms per (arch x input
shape), in seconds, each the mesh's total over its chips' rates:

    compute    = FLOPs / (chips · peak FLOP/s)
    memory     = bytes / (chips · HBM B/s)
    collective = collective bytes / (chips · link B/s)

**The chip.** :data:`H100`, the card these runs use (an H100 SXM): 989e12
dense bf16 FLOP/s and 3.35e12 B/s of HBM3 (the datasheet's figures, the
ones the kernel table's bounds use), and for the link NVLink 4 at 450e9
B/s a direction (the datasheet's; not measured: the card's machine has
one GPU). A 16-rank model line spans two 8-GPU nodes, so half of such a
line's traffic would cross the slower network between them; the term
does not model that. :class:`ChipSpec` is a parameter: :data:`TPU_V5E`
holds the reference's figures (256 chips, 197e12, 819e9, 50e9).

**The counts.** Per rank, the dry run's record (``launch.dryrun``,
``results/dryrun``; made here where it is missing or where a config
override is asked for): its full-depth counts, extrapolated by family
from depth probes (the reference roofline's rules), with ``microbatch=1``
(:func:`corrected_costs`). The reference probes because XLA's
``cost_analysis`` counts a scanned layer once; in eager torch every
layer's ops run, so the probes are exact and only cut the run's Python
time. The totals handed to
:func:`roofline_terms` are the rank's times the chips (every rank of the
mesh runs the same shapes, but for the query heads where they do not
split evenly: rank 0 holds the largest range, so there the attention's
part of its counts times the chips is ``attention_rank0_over_mean`` times
the mesh's, 1.2 for llama4-maverick and 1.33 for qwen2-1.5b at 16, a
bias the record carries and the terms keep); the reference hands it
per-device counts, so its terms are a chip count too small.

**Attention.** The reference adds :func:`attention_cost` to its counts: its
flash tiles sit in rolled scans that ``cost_analysis`` cannot see. On meta
the port's plain attention runs tile by tile, so the counter already sees
every tile: :func:`attention_cost` is a column beside the count
(``attention_flops_global``), never added to it.

``bytes`` is the dry run's unfused count (each op's operands and
results), larger than XLA's fused one: the memory term is an upper bound
of the step's HBM traffic, not the reference's measure.

Usage:  ``PYTHONPATH=src python -m repro_torch.launch.roofline
[--outdir results/roofline] [--dryrun-dir results/dryrun] [--jobs N]``.
Reads ``results/dryrun/*.json``; writes ``results/roofline/roofline.json``
and ``roofline.md``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Optional

from repro_torch.configs import get_config, list_configs
from repro_torch.data.synthetic import shape_params
from repro_torch.launch.dryrun import (SHAPES, applicable, depth_costs_of,
                                       dry_record, in_processes, mesh_name,
                                       meta_params, port_applicable,
                                       record_path)
from repro_torch.launch.mesh import make_dry_production_mesh
from repro_torch.utils.tree import flatten_with_path, keystr


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    name: str
    chips: int
    peak_flops: float          # dense bf16 FLOP/s a chip
    hbm_bw: float              # B/s a chip
    link_bw: float             # B/s a link, one direction


# the datasheet's H100 SXM: dense bf16, HBM3, NVLink 4 (a direction; not
# measured here)
H100 = ChipSpec("H100 SXM", 256, 989e12, 3.35e12, 450e9)
# the reference's TPU v5e single pod
TPU_V5E = ChipSpec("TPU v5e", 256, 197e12, 819e9, 50e9)


# ---------------------------------------------------------------------------
# analytic MODEL_FLOPS
# ---------------------------------------------------------------------------

def count_params(cfg) -> tuple[float, float]:
    """(total_params, active_params) from the port's init shapes on meta,
    in the trainer's per-layer leaves (``layers.split_layers``: the expert
    stacks held 2-D): a leaf named for experts counts ``top_k /
    n_experts`` of itself as active, as in the reference."""
    from repro_torch.models import get_model
    from repro_torch.models.layers import split_layers
    tree = split_layers(meta_params(cfg), get_model(cfg).stacked_layers)
    total = active = 0.0
    for path, leaf in flatten_with_path(tree)[0]:
        n = float(leaf.numel())
        total += n
        if "experts" in keystr(path) and cfg.n_experts:
            active += n * cfg.top_k / cfg.n_experts
        else:
            active += n
    return total, active


def model_flops(cfg, shape_name: str) -> float:
    """6·N_active·tokens (train) / 2·N_active·tokens (inference)."""
    sp = shape_params(shape_name)
    total, active = count_params(cfg)
    if sp["kind"] == "train":
        tokens = sp["batch"] * sp["seq"]
        return 6.0 * active * tokens
    if sp["kind"] == "prefill":
        tokens = sp["batch"] * sp["seq"]
        return 2.0 * active * tokens
    # decode: one token per sequence
    return 2.0 * active * sp["batch"]


# ---------------------------------------------------------------------------
# depth probing
# ---------------------------------------------------------------------------

def corrected_costs(rec: dict) -> dict:
    """The rank's full-depth counts with ``microbatch=1`` from a dry-run
    record (``dryrun.dry_record``): a train step's ``microbatch1`` where
    its config accumulates, else the record's own; ``flops``, ``bytes``,
    ``coll`` and the depth probes behind them."""
    if "microbatch1" in rec:
        return rec["microbatch1"]
    return {"flops": rec["flops"], "bytes": rec["bytes_accessed"],
            "coll": float(rec["collectives"]["total_bytes"]),
            "probes": rec["probes"]}


def load_record(arch: str, shape: str, mesh, dryrun_dir: Optional[str],
                overrides=None) -> dict:
    """The dry run's record of ``arch`` at ``shape`` on ``mesh``: read
    from ``dryrun_dir`` where it is there and no override is asked for,
    else made here (``dryrun.dry_record``, not written). A failed record
    raises: nothing falls back."""
    rec = None
    path = dryrun_dir and record_path(dryrun_dir, arch, shape,
                                      mesh_name(mesh))
    if path and not overrides and os.path.exists(path):
        with open(path) as f:
            rec = json.load(f)
    if rec is None:
        rec = dry_record(arch, shape, mesh, overrides)
    if not rec["ok"]:
        raise RuntimeError(f"{arch} {shape}: {rec['error']}")
    return rec


def step_roofline(cfg, kind: str, batch: int, seq: int, mesh,
                  spec: ChipSpec, cache_len: Optional[int] = None) -> dict:
    """The roofline of a step given outright (``cfg`` at its depth, a
    ``kind`` of the global ``batch`` x ``seq``, a decode's linear
    ``cache_len``) on ``mesh``'s live rank, ``spec.chips`` such ranks: the
    three terms, the rank's counts and the depth probes' records."""
    cfg = dataclasses.replace(cfg, microbatch=1)
    costs, probes = depth_costs_of(cfg, kind, batch, seq, mesh,
                                   cache_len=cache_len)
    terms = roofline_terms(costs["flops"] * spec.chips,
                           costs["bytes"] * spec.chips,
                           costs["coll"] * spec.chips, spec)
    return {**terms, "counts": costs, "probes": probes,
            "chip": dataclasses.asdict(spec)}


def attention_cost(cfg, shape_name: str) -> dict:
    """Analytic flash-attention tile costs (GLOBAL, all layers): the
    reference's, fwd FLOPs/layer = 4·B·Hq·Dh·Sq·Skv_visited, train x4,
    K/V re-read once per q chunk. A column beside the counted FLOPs (which
    already hold the tiles), never added to them."""
    sp = shape_params(shape_name)
    fam = cfg.family
    if fam == "ssm":
        return {"flops": 0.0, "bytes": 0.0}
    B, seq, kind = sp["batch"], sp["seq"], sp["kind"]
    Hq, Dh = max(cfg.n_heads, 1), cfg.head_dim
    dtype_b = 2.0

    def attn(Sq, Skv, layers, train):
        f = 4.0 * B * Hq * Dh * Sq * Skv * layers
        if train:
            f *= 4.0
        nq = max(1, Sq // cfg.attn_chunk)
        by = B * Hq * Dh * dtype_b * (Sq + 2.0 * nq * Skv) * layers
        return f, by

    train = kind == "train"
    if fam == "hybrid":
        from repro_torch.models.hybrid import n_segments
        layers = n_segments(cfg)
    else:
        layers = cfg.n_layers

    if kind in ("train", "prefill"):
        Sq = seq + (cfg.n_patches if fam == "vlm" else 0)
        Skv = Sq
        if kind == "prefill" and cfg.triangle_prefill:
            Skv = Sq / 2.0 + cfg.attn_chunk / 2.0   # lower-triangle tiles only
    else:  # decode: one token against a cache
        Sq = 1
        Skv = min(seq, cfg.sliding_window or seq) if fam in (
            "dense", "moe", "vlm") else seq
        if fam == "hybrid":
            Skv = seq
    f, by = attn(Sq, Skv, layers, train)
    if fam == "audio":
        # + encoder self-attention (bidirectional) + decoder cross-attn
        fe, be = attn(cfg.enc_seq, cfg.enc_seq, cfg.enc_layers, train)
        if kind in ("train", "prefill"):
            fc, bc = attn(seq, cfg.enc_seq, cfg.n_layers, train)
        else:
            fc, bc = attn(1, cfg.enc_seq, cfg.n_layers, False)
        f, by = f + fe + fc, by + be + bc
    return {"flops": f, "bytes": by}


# ---------------------------------------------------------------------------
# terms + report
# ---------------------------------------------------------------------------

def roofline_terms(flops, bytes_, coll, spec: ChipSpec = H100) -> dict:
    """The three terms of the mesh's total ``flops``, ``bytes_`` and
    ``coll`` over ``spec.chips`` chips, and the dominant one."""
    compute = flops / (spec.chips * spec.peak_flops)
    memory = bytes_ / (spec.chips * spec.hbm_bw)
    collective = coll / (spec.chips * spec.link_bw)
    dom = max(("compute", compute), ("memory", memory),
              ("collective", collective), key=lambda t: t[1])[0]
    return {"compute_s": compute, "memory_s": memory,
            "collective_s": collective, "dominant": dom}


WHAT_MOVES = {
    "compute": "raise arithmetic efficiency: larger fused matmul tiles / "
               "remove remat recompute (MODEL/HLO ratio shows the waste)",
    "memory": "cut HBM traffic: fuse elementwise chains, bf16 residuals, "
              "bigger flash tiles so Q/K/V stream once",
    "collective": "reshard: move the dominant all-gather/reduce-scatter off "
                  "the critical axis, overlap collectives with compute, or "
                  "shrink TP degree for this op",
}


def analyze(arch: str, shape: str, mesh, dryrun_dir: str, overrides=None,
            spec: ChipSpec = H100) -> dict:
    """The roofline record of ``arch`` at ``shape`` on ``mesh`` (its live
    rank's counts from the dry run's record, :func:`load_record`;
    ``spec.chips`` such ranks): the reference's keys, and the port's
    ``attention_flops_global``, ``argument_bytes_per_device``, ``chip``
    and the depth probes' records (``probes``)."""
    overrides = overrides or {}
    cfg = dataclasses.replace(get_config(arch), **overrides)
    ok, why = applicable(cfg, shape)
    if ok:
        ok, why = port_applicable(cfg, mesh)
    if not ok:
        return {"arch": arch, "shape": shape, "skipped": True, "reason": why}
    t0 = time.time()
    raw = load_record(arch, shape, mesh, dryrun_dir, overrides)
    corr = corrected_costs(raw)
    attn = attention_cost(cfg, shape)
    chips = spec.chips
    terms = roofline_terms(corr["flops"] * chips, corr["bytes"] * chips,
                           corr["coll"] * chips, spec)
    mf = model_flops(cfg, shape)
    ratio = mf / max(corr["flops"] * chips, 1.0)
    return {
        "arch": arch, "shape": shape, "skipped": False,
        "hlo_flops_raw_per_device": raw["flops"],
        "hlo_flops_corrected_per_device": corr["flops"],
        "hlo_bytes_corrected_per_device": corr["bytes"],
        "collective_bytes_corrected_per_device": corr["coll"],
        "model_flops_global": mf,
        "model_over_hlo_ratio": ratio,
        **terms,
        "bottleneck_fix": WHAT_MOVES[terms["dominant"]],
        "probe_seconds": round(time.time() - t0, 1),
        "temp_bytes_per_device": raw["memory"]["temp_bytes"],
        "argument_bytes_per_device": raw["memory"]["argument_bytes"],
        "attention_flops_global": attn["flops"],
        "attention_bytes_global": attn["bytes"],
        "chip": dataclasses.asdict(spec),
        "probes": corr["probes"],
        # rank 0 holds the most query heads where they do not split evenly:
        # its attention counts times the chips overstate the mesh's so much
        "attention_rank0_over_mean": raw.get("query_heads", {}).get(
            "rank0_over_mean", 1.0),
    }


def _analyze_one(arch, shape, dryrun_dir):
    return analyze(arch, shape, make_dry_production_mesh(), dryrun_dir)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--outdir", default="results/roofline")
    ap.add_argument("--dryrun-dir", default="results/dryrun")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--jobs", type=int, default=1,
                    help="pairs run at once, one process each")
    args = ap.parse_args(argv)
    os.makedirs(args.outdir, exist_ok=True)

    archs = list_configs() if args.arch == "all" else [args.arch]
    shapes = SHAPES if args.shape == "all" else [args.shape]
    out = []
    out_path = os.path.join(args.outdir, "roofline.json")
    if os.path.exists(out_path):     # resume: keep completed pairs
        with open(out_path) as f:
            out = json.load(f)
    done = {(r["arch"], r["shape"]) for r in out}
    todo = [(a, s, args.dryrun_dir) for a in archs for s in shapes
            if (a, s) not in done]
    for rec in in_processes(_analyze_one, todo, args.jobs):
        out.append(rec)
        arch, shape = rec["arch"], rec["shape"]
        if rec.get("skipped"):
            print(f"[roofline] {arch:28s} {shape:12s} SKIP {rec['reason']}",
                  flush=True)
        else:
            print(f"[roofline] {arch:28s} {shape:12s} "
                  f"comp={rec['compute_s']:.2e}s mem={rec['memory_s']:.2e}s "
                  f"coll={rec['collective_s']:.2e}s -> {rec['dominant']:10s} "
                  f"model/hlo={rec['model_over_hlo_ratio']:.2f}", flush=True)
        with open(out_path, "w") as f:
            json.dump(out, f, indent=1)
    _write_md(out, os.path.join(args.outdir, "roofline.md"))


def _gb(x) -> str:
    return "—" if x is None else f"{x / 1e9:.1f}"


def _write_md(records: list, path: str) -> None:
    """The reference's table, with each rank's argument and temp bytes
    (GB, against the card's 80) after its columns."""
    lines = [
        "| arch | shape | compute s | memory s | collective s | dominant |"
        " MODEL_FLOPS | model/HLO | next move | args GB/rank | temp GB/rank |"
        " attention rank 0 / mean |",
        "|---|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in records:
        if r.get("skipped"):
            lines.append(f"| {r['arch']} | {r['shape']} | — | — | — "
                         f"| skip ({r['reason']}) "
                         "| — | — | — | — | — | — |")
            continue
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['compute_s']:.2e} | "
            f"{r['memory_s']:.2e} | {r['collective_s']:.2e} | "
            f"**{r['dominant']}** | {r['model_flops_global']:.2e} | "
            f"{r['model_over_hlo_ratio']:.2f} | {r['bottleneck_fix']} | "
            f"{_gb(r.get('argument_bytes_per_device'))} | "
            f"{_gb(r.get('temp_bytes_per_device'))} | "
            f"{r.get('attention_rank0_over_mean', 1.0):.3g} |")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
