#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each of which fails the run if it fails:

1. Set-up: print the card's name and power limit, build the CUDA kernels
   from ``src/repro_torch/csrc`` into ``build/repro_torch/``.
2. Every kernel against its plain PyTorch version on a 1,543,714,304-value
   float32 parameter tree with the leaf shapes of qwen2-1.5b (tied
   embedding, 28 layers; 6,295 blocks of 128 rows), at the shapes the main
   path gives each kernel: block_dist within rtol 1e-4, scatter_save and
   masked_restore bit-exact. Whole-tree times from CUDA events (median of
   7, plain and kernel in turns), beside the least time the card could
   take (bytes over 3.35 TB/s; operations over 67 TFLOP/s f32).
3. The main path: ``make_model("mlr")`` at its defaults on ``cuda``;
   ``run_clean``, ``run_with_failure`` with ``CheckpointPolicy.scar()``
   and ``CheckpointPolicy.traditional()``, the Theorem 3.2 bound as the
   quickstart computes it, and the same SCAR run on the CPU to hold the
   card's losses and iteration cost against. Then every kernel against
   its plain version at the MLR leaves' own shapes (a ragged two-block
   ``w``, a one-block ``b`` shorter than a block).
4. The controller at full size: ``FTController`` on the 1.54 B tree, drift
   steps with PRIORITY 1/8 partial saves, a failure of half the blocks,
   PARTIAL recovery held bit for bit against the plain restore.
5. Launch counts, one set per path: the counts are set to 0 just before
   the MLR loops and read just after them, and again around the
   controller. Every kernel must have launched in each path.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device it exits non-zero
and prints no result.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
F32_FLOPS_PER_S = 67e12          # H100 SXM, f32 outside the tensor cores
BLOCK_ROWS = 128
TIMING_RUNS = 7
SEED = 0


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def qwen2_1_5b_shapes() -> dict:
    """One leaf per weight of qwen2-1.5b (arXiv:2407.10671): 28 layers,
    d_model 1536, 12 heads with 2 kv heads of 128, d_ff 8960, vocab 151936,
    QKV biases, tied embedding."""
    d, kv, ff = 1536, 256, 8960
    layer = {"q": (d, d), "k": (d, kv), "v": (d, kv), "o": (d, d),
             "q_bias": (d,), "k_bias": (kv,), "v_bias": (kv,),
             "gate": (d, ff), "up": (d, ff), "down": (ff, d),
             "attn_norm": (d,), "mlp_norm": (d,)}
    return {"embed": (151936, d), "layers": [dict(layer) for _ in range(28)],
            "final_norm": (d,)}


def _map_shapes(shapes, fn):
    if isinstance(shapes, dict):
        return {k: _map_shapes(v, fn) for k, v in shapes.items()}
    if isinstance(shapes, list):
        return [_map_shapes(v, fn) for v in shapes]
    return fn(shapes)


def cuda_ms(fn, runs: int = TIMING_RUNS) -> list[float]:
    import torch
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def in_turns(fns: dict) -> dict:
    """Median ms of each whole-tree pass, the passes taken in turns."""
    import torch
    for fn in fns.values():            # warm-up (allocator, first launch)
        fn()
    torch.cuda.synchronize()
    times = {name: [] for name in fns}
    for _ in range(TIMING_RUNS):
        for name, fn in fns.items():
            times[name] += cuda_ms(fn, runs=1)
    return {name: statistics.median(t) for name, t in times.items()}


def host_us(fn, calls: int = 300) -> float:
    """Host microseconds per call of ``fn`` on a small input (the card
    keeps up, so this is the launch path's own cost)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def device_ms(fn, calls: int = 10) -> float:
    """Card milliseconds per call, back to back on one stream."""
    return statistics.median(cuda_ms(lambda: [fn() for _ in range(calls)],
                                     runs=3)) / calls


def device_share(fn) -> dict:
    """Run ``fn`` once under torch.profiler: its wall seconds (ending in a
    synchronize), the seconds the card spent in kernels and copies, and the
    five names that took most of them. ``device_s`` is 0 where the
    profiler records no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [(e.key, e.self_device_time_total) for e in prof.key_averages()
            if e.self_device_time_total > 0]
    device_s = sum(us for _, us in rows) / 1e6
    top = sorted(rows, key=lambda r: -r[1])[:5]
    return {"wall_s": wall, "device_s": device_s,
            "busy_share": device_s / wall if wall > 0 else None,
            "top_device_ms": [[k[:60], us / 1e3] for k, us in top]}


def bound_ms(n_bytes: float, n_flops: float = 0.0) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions at full size
# ---------------------------------------------------------------------------

def phase_kernels(a_tree, b_tree, device) -> dict:
    import torch
    from repro_torch.core.blocks import leaf_block_view, partition_pytree
    from repro_torch.kernels.block_dist.kernel import block_dist_cuda
    from repro_torch.kernels.block_dist.ref import block_dist_ref
    from repro_torch.kernels.fused_maintain.kernel import scatter_save_cuda
    from repro_torch.kernels.fused_maintain.ref import scatter_save_ref
    from repro_torch.kernels.masked_restore.kernel import masked_restore_cuda
    from repro_torch.kernels.masked_restore.ref import masked_restore_ref
    from repro_torch.utils.tree import tree_leaves

    part = partition_pytree(a_tree, BLOCK_ROWS)
    a_leaves, b_leaves = tree_leaves(a_tree), tree_leaves(b_tree)
    names = [l.name for l in part.leaves]
    # per-call measurements on the largest leaf and on a small one
    big, small = names.index("['embed']"), names.index("['final_norm']")
    n_values = sum(x.numel() for x in a_leaves)
    log(f"tree: {len(a_leaves)} leaves, {n_values} f32 values, "
        f"{part.total_blocks} blocks of {BLOCK_ROWS} rows")
    check(n_values == 1_543_714_304 and part.total_blocks == 6295,
          "the tree does not have qwen2-1.5b's size")
    views = [(leaf_block_view(x, BLOCK_ROWS), leaf_block_view(y, BLOCK_ROWS))
             for x, y in zip(a_leaves, b_leaves)]
    rows2d = [(x.reshape(l.rows, max(l.row_width, 1)),
               y.reshape(l.rows, max(l.row_width, 1)))
              for x, y, l in zip(a_leaves, b_leaves, part.leaves)]
    gen = torch.Generator().manual_seed(SEED + 1)
    masks, sel = [], []
    moved = 0
    for leaf in part.leaves:
        masks.append((torch.rand(leaf.n_blocks, generator=gen) < 0.5)
                     .to(device))
        k = max(1, leaf.n_blocks // 8)
        ids = torch.randperm(leaf.n_blocks, generator=gen)[:k]
        sel.append(ids.to(torch.int32).to(device))
        rows = (torch.clamp((ids + 1) * BLOCK_ROWS, max=leaf.rows)
                - ids * BLOCK_ROWS)
        moved += int(rows.sum()) * leaf.row_width * 4
    results = {}

    # block_dist: rtol 1e-4 (f32 sums in another order over <= 1.1 M terms)
    err = 0.0
    for va, vb in views:
        got, want = block_dist_cuda(va, vb), block_dist_ref(va, vb)
        rel = ((got - want).abs() / want.abs().clamp_min(1e-30)).max()
        check(float(rel) <= 1e-4, f"block_dist off by rtol {float(rel)}")
        check(torch.equal(got, block_dist_cuda(va, vb)),
              "block_dist differs between two runs")
        err = max(err, float((got - want).abs().max()))
    t = in_turns({
        "plain": lambda: [block_dist_ref(va, vb) for va, vb in views],
        "kernel": lambda: [block_dist_cuda(va, vb) for va, vb in views]})
    b, by = bound_ms(2 * 4 * n_values + 4 * part.total_blocks, 3 * n_values)
    results["block_dist"] = dict(max_abs_err=err, ms=t["kernel"],
                                 plain_ms=t["plain"], bound_ms=b, bound_by=by,
                                 library_ms=None)
    (ba, bb), (sa, sb) = views[big], views[small]
    results["block_dist"].update(
        leaf_ms=device_ms(lambda: block_dist_cuda(ba, bb)),
        leaf_plain_ms=device_ms(lambda: block_dist_ref(ba, bb)),
        leaf_bound_ms=bound_ms(8 * ba.numel() + 4 * ba.shape[0])[0],
        host_us=host_us(lambda: block_dist_cuda(sa, sb)),
        plain_host_us=host_us(lambda: block_dist_ref(sa, sb)))

    # masked_restore on the raw (R, W) rows, as the main path calls it:
    # bit-exact. Every leaf of this tree fills its blocks, so its block
    # view is a view, and torch.where on it is the one-call yardstick.
    for (dv, sv), m in zip(rows2d, masks):
        check(torch.equal(masked_restore_cuda(dv, sv, m, BLOCK_ROWS),
                          masked_restore_ref(dv, sv, m, BLOCK_ROWS)),
              "masked_restore differs from its plain version")
    check(all(va.data_ptr() == x.data_ptr() for (va, _), x
              in zip(views, a_leaves)), "a block view is a padded copy")
    t = in_turns({
        "plain": lambda: [masked_restore_ref(dv, sv, m, BLOCK_ROWS)
                          for (dv, sv), m in zip(rows2d, masks)],
        "kernel": lambda: [masked_restore_cuda(dv, sv, m, BLOCK_ROWS)
                           for (dv, sv), m in zip(rows2d, masks)],
        "library": lambda: [torch.where(m[:, None], sv, dv)
                            for (dv, sv), m in zip(views, masks)]})
    b, by = bound_ms(2 * 4 * n_values + part.total_blocks)
    results["masked_restore"] = dict(max_abs_err=0.0, ms=t["kernel"],
                                     plain_ms=t["plain"], bound_ms=b,
                                     bound_by=by, library_ms=t["library"])
    (ra, rb), (rsa, rsb) = rows2d[big], rows2d[small]
    bm, sm = masks[big], masks[small]
    results["masked_restore"].update(
        leaf_ms=device_ms(lambda: masked_restore_cuda(ra, rb, bm,
                                                      BLOCK_ROWS)),
        leaf_plain_ms=device_ms(lambda: masked_restore_ref(ra, rb, bm,
                                                           BLOCK_ROWS)),
        leaf_bound_ms=bound_ms(8 * ra.numel() + bm.numel())[0],
        host_us=host_us(lambda: masked_restore_cuda(rsa, rsb, sm,
                                                    BLOCK_ROWS)),
        plain_host_us=host_us(lambda: masked_restore_ref(rsa, rsb, sm,
                                                         BLOCK_ROWS)))

    # scatter_save: bit-exact on copies, then timed in place into b (the
    # same ids each run, so every run writes the same bytes)
    for (src, dst), ids in zip(rows2d, sel):
        got = scatter_save_cuda(dst.clone(), src, ids, BLOCK_ROWS)
        want = scatter_save_ref(dst.clone(), src, ids, BLOCK_ROWS)
        check(torch.equal(got, want),
              "scatter_save differs from its plain version")
    t = in_turns({
        "plain": lambda: [scatter_save_ref(dst, src, ids, BLOCK_ROWS)
                          for (src, dst), ids in zip(rows2d, sel)],
        "kernel": lambda: [scatter_save_cuda(dst, src, ids, BLOCK_ROWS)
                           for (src, dst), ids in zip(rows2d, sel)]})
    b, by = bound_ms(2 * moved + 4 * sum(int(s.numel()) for s in sel))
    results["scatter_save"] = dict(max_abs_err=0.0, ms=t["kernel"],
                                   plain_ms=t["plain"], bound_ms=b,
                                   bound_by=by, library_ms=None,
                                   moved_bytes=moved)
    (bsrc, bdst), bids = rows2d[big], sel[big]
    (ssrc, sdst), sids = rows2d[small], sel[small]
    big_leaf = part.leaves[big]
    results["scatter_save"].update(
        leaf_ms=device_ms(lambda: scatter_save_cuda(bdst, bsrc, bids,
                                                    BLOCK_ROWS)),
        leaf_plain_ms=device_ms(lambda: scatter_save_ref(bdst, bsrc, bids,
                                                         BLOCK_ROWS)),
        leaf_bound_ms=bound_ms(2 * 4 * bids.numel() * BLOCK_ROWS
                               * big_leaf.row_width)[0],
        host_us=host_us(lambda: scatter_save_cuda(sdst, ssrc, sids,
                                                  BLOCK_ROWS)),
        plain_host_us=host_us(lambda: scatter_save_ref(sdst, ssrc, sids,
                                                       BLOCK_ROWS)))
    for name, r in results.items():
        lib = r["library_ms"]
        log(f"{name}: kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, "
            f"bound {r['bound_ms']:.3f} ms ({r['bound_by']}), library "
            f"{'none' if lib is None else format(lib, '.3f') + ' ms'}, "
            f"max abs err {r['max_abs_err']:.3g}; largest leaf "
            f"{r['leaf_ms']:.4f} ms (plain {r['leaf_plain_ms']:.4f}, bound "
            f"{r['leaf_bound_ms']:.4f}); host {r['host_us']:.1f} us per call "
            f"(plain {r['plain_host_us']:.1f})")
    return results


# ---------------------------------------------------------------------------
# phase 3: the main path -- the fabric-less SCAR loop on MLR
# ---------------------------------------------------------------------------

def phase_mlr(device) -> dict:
    import numpy as np
    import torch
    from repro_torch.core.iteration_cost import (estimate_contraction,
                                                 iterations_to_eps,
                                                 single_perturbation_bound)
    from repro_torch.core.policy import CheckpointPolicy
    from repro_torch.models.classic import make_model
    from repro_torch.training.classic_runner import run_clean, run_with_failure

    t0 = time.perf_counter()
    model = make_model("mlr")                 # n=2000, dim=196, 10 classes
    check(model.device.type == "cuda", "make_model did not default to cuda")
    clean = run_clean(model, max_iters=150)["losses"]
    kappa = iterations_to_eps(clean, model.eps)
    scar = run_with_failure(model, CheckpointPolicy.scar(), fail_iter=25,
                            fail_fraction=0.5, max_iters=150,
                            clean_losses=clean)
    trad = run_with_failure(model, CheckpointPolicy.traditional(),
                            fail_iter=25, fail_fraction=0.5, max_iters=150,
                            clean_losses=clean)
    c = estimate_contraction(np.sqrt(np.maximum(
        np.asarray(clean) - min(clean) * 0.98, 1e-9))[:100], burn_in=3)
    delta = float(np.sqrt(scar["recovery"]["applied_sq"]))
    x0 = model.distance(model.init(torch.Generator().manual_seed(1)))
    bound = single_perturbation_bound(delta, c, T=25, x0_err=x0)
    seconds = time.perf_counter() - t0
    profiled = device_share(lambda: run_with_failure(
        model, CheckpointPolicy.scar(), fail_iter=25, fail_fraction=0.5,
        max_iters=150, clean_losses=clean))
    log(f"mlr SCAR run under the profiler: {json.dumps(profiled)}")
    for run in (clean, scar["losses"], trad["losses"]):
        check(len(run) == 150 and bool(np.all(np.isfinite(run))),
              "MLR losses are not 150 finite values")
    check(kappa < 150, f"clean MLR run did not reach eps (kappa {kappa})")
    check(math.isfinite(bound) and bound >= 0, f"bad bound {bound}")
    log(f"mlr on {device}: kappa_clean {kappa}, SCAR iteration cost "
        f"{scar['iteration_cost']}, traditional iteration cost "
        f"{trad['iteration_cost']}, Theorem 3.2 bound {bound:.3f} "
        f"(c={c:.4f}), recovery {scar['recovery']}, {seconds:.2f} s")
    return {"model": model, "clean": clean, "scar": scar, "trad": trad,
            "kappa": kappa, "bound": bound, "profile": profiled}


def check_mlr_against_cpu(gpu: dict) -> None:
    """The same SCAR run on the CPU (same draws, same failure mask): the
    CPU port is held to the JAX package by the tests, the card to it."""
    import numpy as np
    from repro_torch.core.iteration_cost import iterations_to_eps
    from repro_torch.core.policy import CheckpointPolicy
    from repro_torch.models.classic import make_model
    from repro_torch.training.classic_runner import run_clean, run_with_failure

    model = make_model("mlr", device="cpu")
    check(abs(model.eps - gpu["model"].eps) <= 1e-4 * abs(model.eps),
          "eps differs between the CPU and the card")
    clean = run_clean(model, max_iters=150, device="cpu")["losses"]
    scar = run_with_failure(model, CheckpointPolicy.scar(), fail_iter=25,
                            fail_fraction=0.5, max_iters=150,
                            clean_losses=clean, device="cpu")
    np.testing.assert_allclose(gpu["clean"], clean, rtol=1e-4)
    np.testing.assert_allclose(gpu["scar"]["losses"], scar["losses"],
                               rtol=1e-4)
    check(iterations_to_eps(clean, model.eps) == gpu["kappa"],
          "kappa_clean differs between the CPU and the card")
    check(abs(scar["iteration_cost"] - gpu["scar"]["iteration_cost"]) <= 1,
          "SCAR iteration cost differs between the CPU and the card")
    log(f"mlr on cpu: SCAR iteration cost {scar['iteration_cost']}, losses "
        f"agree with the card within rtol 1e-4")


def check_kernels_on_mlr(model, device) -> None:
    """Each kernel against its plain version at the shapes the MLR path
    hands it: the block views ``block_scores`` makes and the raw (R, W)
    rows the save and the restore take, at the SCAR policy's block_rows.
    Seeded random values (the model's init is all zeros)."""
    import torch
    from repro_torch.core.blocks import leaf_block_view, partition_pytree
    from repro_torch.core.policy import CheckpointPolicy
    from repro_torch.kernels.block_dist.kernel import block_dist_cuda
    from repro_torch.kernels.block_dist.ref import block_dist_ref
    from repro_torch.kernels.fused_maintain.kernel import scatter_save_cuda
    from repro_torch.kernels.fused_maintain.ref import scatter_save_ref
    from repro_torch.kernels.masked_restore.kernel import masked_restore_cuda
    from repro_torch.kernels.masked_restore.ref import masked_restore_ref
    from repro_torch.utils.tree import tree_leaves

    br = CheckpointPolicy.scar().block_rows
    shapes = model.init(torch.Generator().manual_seed(1))
    part = partition_pytree(shapes, br)
    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    seen = []
    for x, leaf in zip(tree_leaves(shapes), part.leaves):
        a = torch.randn(x.shape, generator=gen, device=device)
        b = torch.randn(x.shape, generator=gen, device=device)
        va, vb = leaf_block_view(a, br), leaf_block_view(b, br)
        got, want = block_dist_cuda(va, vb), block_dist_ref(va, vb)
        check(bool(torch.all((got - want).abs() <= 1e-4 * want.abs())),
              f"block_dist off at {leaf.name} {tuple(va.shape)}")
        a2 = a.reshape(leaf.rows, leaf.row_width)
        b2 = b.reshape(leaf.rows, leaf.row_width)
        last = leaf.n_blocks - 1
        ids = torch.tensor([last, 0, last], dtype=torch.int32, device=device)
        check(torch.equal(scatter_save_cuda(b2.clone(), a2, ids, br),
                          scatter_save_ref(b2.clone(), a2, ids, br)),
              f"scatter_save differs at {leaf.name}")
        alt = torch.arange(leaf.n_blocks, device=device) % 2 == 1
        for m in (alt, ~alt):
            check(torch.equal(masked_restore_cuda(b2, a2, m, br),
                              masked_restore_ref(b2, a2, m, br)),
                  f"masked_restore differs at {leaf.name}")
        seen.append(f"{leaf.name} rows {tuple(a2.shape)} view "
                    f"{tuple(va.shape)}")
    log(f"kernels agree with their plain versions on the MLR leaves "
        f"(block_rows {br}): {'; '.join(seen)}")


# ---------------------------------------------------------------------------
# phase 4: the controller at full size
# ---------------------------------------------------------------------------

def phase_controller(tree, device) -> dict:
    import torch
    from repro_torch.core.controller import FTController
    from repro_torch.core.policy import CheckpointPolicy
    from repro_torch.kernels.masked_restore.ref import masked_restore_ref
    from repro_torch.utils.tree import tree_leaves

    ctl = FTController(tree, CheckpointPolicy.scar())
    part = ctl.partition
    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    steps = 3
    for step in range(1, steps + 1):
        for x in tree_leaves(tree):
            x.add_(torch.randn(x.shape, generator=gen, device=device),
                   alpha=1e-3)
        check(ctl.maybe_checkpoint(step, tree), f"no save at step {step}")
    k = part.blocks_for_k(ctl.policy.fraction)
    check(ctl.stats["blocks_saved"] == steps * k, "wrong number of blocks")
    # one more drift step and save, under the profiler
    for x in tree_leaves(tree):
        x.add_(torch.randn(x.shape, generator=gen, device=device), alpha=1e-3)
    steps += 1
    profiled = device_share(lambda: ctl.checkpoint_now(steps, tree))
    log(f"one PRIORITY save at 1.54 B under the profiler: "
        f"{json.dumps(profiled)}")
    lost = ctl.sample_failure(0.5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    recovered, info = ctl.on_failure(tree, lost, step=steps)
    torch.cuda.synchronize()
    recovery_s = time.perf_counter() - t0
    masks = [lost[l.offset:l.offset + l.n_blocks] for l in part.leaves]
    for x, z, r, m, leaf in zip(tree_leaves(tree), tree_leaves(ctl.ckpt.values),
                                tree_leaves(recovered), masks, part.leaves):
        shape2d = (leaf.rows, leaf.row_width)
        want = masked_restore_ref(x.reshape(shape2d), z.reshape(shape2d), m,
                                  part.block_rows)
        check(torch.equal(r, want.reshape(leaf.shape)),
              f"recovered {leaf.name} differs from the plain restore")
    check(info["applied_sq"] <= info["full_sq"] and info["applied_sq"] > 0,
          f"bad perturbation norms {info}")
    out = {"saves": ctl.stats["saves"],
           "save_seconds": ctl.stats["save_seconds"],
           "save_bytes_moved": ctl.stats["save_bytes_moved"],
           "recovery_seconds": recovery_s, "blocks_per_save": k,
           "lost_blocks": info["lost_blocks"],
           "applied_sq": info["applied_sq"], "full_sq": info["full_sq"],
           "profiled_save": profiled}
    log(f"controller at 1.54 B values: {json.dumps(out)}")
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    from repro_torch.utils.tree import tree_leaves

    device = torch.device("cuda", 0)
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    _build.library()
    built = _build.build_seconds
    log(f"kernels: {'built in ' + format(built, '.1f') + ' s' if built else 'reused'}"
        f" ({time.perf_counter() - t0:.1f} s to load)")

    gen = torch.Generator(device=device).manual_seed(SEED)
    shapes = qwen2_1_5b_shapes()
    a_tree = _map_shapes(shapes, lambda s: torch.randn(
        s, generator=gen, device=device))
    b_tree = _map_shapes(shapes, lambda s: torch.empty(s, device=device))
    for x, y in zip(tree_leaves(a_tree), tree_leaves(b_tree)):
        y.copy_(x).add_(torch.randn(x.shape, generator=gen, device=device),
                        alpha=1e-2)
    kernels = phase_kernels(a_tree, b_tree, device)
    del b_tree
    torch.cuda.empty_cache()
    log(f"peak device memory after phase 2: "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

    # each path's own launch counts: set to 0 just before it, read just
    # after it; the kernel-against-plain checks run outside both windows
    _build.reset_launches()
    mlr = phase_mlr(device)
    launches = dict(_build.LAUNCHES)
    check_mlr_against_cpu(mlr)
    check_kernels_on_mlr(mlr["model"], device)
    _build.reset_launches()
    ctl = phase_controller(a_tree, device)
    ctl_launches = dict(_build.LAUNCHES)
    log(json.dumps({"launches": {"mlr": launches,
                                 "controller": ctl_launches}}))
    for path, counts in (("MLR", launches), ("controller", ctl_launches)):
        for name, n in counts.items():
            check(n > 0, f"{name} was not launched on the {path} path")
    log(f"peak device memory: {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

    sources = {"block_dist": ("src/repro_torch/csrc/block_dist.cu",
                              "src/repro/kernels/block_dist/kernel.py:41"),
               "scatter_save": ("src/repro_torch/csrc/scatter_save.cu",
                                "src/repro/kernels/fused_maintain/kernel.py:245"),
               "masked_restore": ("src/repro_torch/csrc/masked_restore.cu",
                                  "src/repro/kernels/masked_restore/kernel.py:31")}
    record = []
    for name, (source, replaces) in sources.items():
        r = kernels[name]
        record.append({"name": name, "route": "cuda", "source": source,
                       "replaces": replaces, "launches": launches[name],
                       "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                       "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                       "bound_by": r["bound_by"],
                       "library_ms": r["library_ms"]})
    log(json.dumps({"controller": ctl, "mlr": {
        "kappa_clean": mlr["kappa"],
        "scar_iteration_cost": mlr["scar"]["iteration_cost"],
        "traditional_iteration_cost": mlr["trad"]["iteration_cost"],
        "bound": mlr["bound"], "profiled_scar_run": mlr["profile"]},
        "per_call": {name: {k: r[k] for k in (
            "leaf_ms", "leaf_plain_ms", "leaf_bound_ms", "host_us",
            "plain_host_us")} for name, r in kernels.items()},
        "scatter_save_moved_bytes": kernels["scatter_save"]["moved_bytes"]}))
    log(card)
    log(json.dumps({"kernels": record}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
