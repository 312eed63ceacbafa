"""The §Perf pairs: each pair's baseline against its variant, on the
roofline terms of one rank of the dry ``(16, 16)`` production mesh.

The port of ``repro.launch.perf``: the same four pairs, each a config
flag turned on, each read on the term the reference's hypothesis names.
It reports what the port does; no route changes to make a pair move.

  A. command-r-plus-104b x prefill_32k, ``triangle_prefill`` (compute).
     The reference's causal prefill visits every kv tile and masks half;
     the flag skips the upper triangle. The port's causal prefill already
     visits only the tiles at or below the diagonal, with the flag or
     without (``models.transformer.prefill_attention``): about 0%.
  B. qwen3-moe-235b-a22b x train_4k, ``moe_reduce_scatter``
     (collective). The port's train step keeps the residual stream
     S-sharded over the model line (``models.layers.seq_axis``), so its
     MoE combine is a reduce-scatter to the rank's piece of S with the
     flag or without it (the flag chooses a route only where the stream
     is replicated: serving, a sequence that does not split): 0%, where
     the reference's baseline all-reduces the combine and reads 16x from
     its result-shape accounting.
  C. command-r-plus-104b x decode_32k, ``kv_quant`` (memory): the int8
     cache against the bf16 one. The port's bf16 decode also repeats the
     cache over the query group, so its memory term falls by more than the
     cache's halving.
  B2. B with ``moe_no_fsdp`` (collective): the flag changes the experts'
     partition specs only; the arena step gathers every leaf either way.

Each analysis is ``roofline.analyze``'s: a baseline reads the dry run's
record (``results/dryrun``) where there is one, a variant is probed here.

Usage: ``PYTHONPATH=src python -m repro_torch.launch.perf [--pair
A|B|C|B2|all] [--jobs N]``. Writes ``results/perf/<pair>.json``.
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch.launch.dryrun import in_processes
from repro_torch.launch.mesh import make_dry_production_mesh
from repro_torch.launch.roofline import analyze

PAIRS = {
    "A": dict(arch="command-r-plus-104b", shape="prefill_32k",
              overrides={"triangle_prefill": True},
              term="compute_s"),
    "B": dict(arch="qwen3-moe-235b-a22b", shape="train_4k",
              overrides={"moe_reduce_scatter": True},
              term="collective_s"),
    "C": dict(arch="command-r-plus-104b", shape="decode_32k",
              overrides={"kv_quant": True},
              term="memory_s"),
    "B2": dict(arch="qwen3-moe-235b-a22b", shape="train_4k",
               overrides={"moe_reduce_scatter": True, "moe_no_fsdp": True},
               term="collective_s"),
}
TERMS = ("compute_s", "memory_s", "collective_s", "dominant")


def _analyze(arch, shape, overrides, dryrun_dir):
    return analyze(arch, shape, make_dry_production_mesh(), dryrun_dir,
                   overrides=overrides)


def pair_record(name: str, base: dict, opt: dict) -> dict:
    """The reference's record of pair ``name`` from its two analyses."""
    p = PAIRS[name]
    term = p["term"]
    delta = 100.0 * (base[term] - opt[term]) / max(base[term], 1e-30)
    return {"pair": name, **{k: p[k] for k in ("arch", "shape", "term")},
            "overrides": p["overrides"],
            "baseline": {k: base[k] for k in TERMS},
            "optimized": {k: opt[k] for k in TERMS},
            "dominant_term_improvement_pct": delta}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pair", default="all", choices=list(PAIRS) + ["all"])
    ap.add_argument("--outdir", default="results/perf")
    ap.add_argument("--dryrun-dir", default="results/dryrun")
    ap.add_argument("--jobs", type=int, default=1,
                    help="analyses run at once, one process each")
    args = ap.parse_args(argv)
    os.makedirs(args.outdir, exist_ok=True)
    pairs = PAIRS if args.pair == "all" else {args.pair: PAIRS[args.pair]}
    # each distinct analysis once (B and B2 share their baseline)
    runs = []
    for p in pairs.values():
        for over in ({}, p["overrides"]):
            key = (p["arch"], p["shape"], tuple(sorted(over.items())))
            if key not in runs:
                runs.append(key)
    done = dict(zip(runs, in_processes(
        _analyze, [(a, s, dict(o), args.dryrun_dir) for a, s, o in runs],
        args.jobs)))
    for name, p in pairs.items():
        base = done[(p["arch"], p["shape"], ())]
        opt = done[(p["arch"], p["shape"],
                    tuple(sorted(p["overrides"].items())))]
        rec = pair_record(name, base, opt)
        term = p["term"]
        with open(os.path.join(args.outdir, f"{name}.json"), "w") as f:
            json.dump(rec, f, indent=1)
        print(f"[perf {name}] {p['arch']} {p['shape']} {term}: "
              f"{base[term]:.3e}s -> {opt[term]:.3e}s "
              f"({rec['dominant_term_improvement_pct']:+.1f}% improvement)",
              flush=True)
        print(f"         baseline terms: comp={base['compute_s']:.2e} "
              f"mem={base['memory_s']:.2e} coll={base['collective_s']:.2e} "
              f"dom={base['dominant']}", flush=True)
        print(f"         optimized terms: comp={opt['compute_s']:.2e} "
              f"mem={opt['memory_s']:.2e} coll={opt['collective_s']:.2e} "
              f"dom={opt['dominant']}", flush=True)


if __name__ == "__main__":
    main()
