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
   take (bytes over 3.35 TB/s; operations over 67 TFLOP/s f32, or, for
   gf256_mac's integer work, over the card's INT32 rate: its SMs x 64
   lanes x its maximum SM clock).
3. The arena kernels at full size: the same tree packed into the flat
   word arena (1,544,728,576 words) with ``FabricConfig()``'s parity
   striping. arena_maintain (parity bit-exact, scores within rtol 1e-4),
   arena_scatter (a seeded 1/8 of the blocks, bit-exact) and parity_xor
   (the whole-arena encode, bit-exact and equal to the sweep's parity),
   timed as in phase 2.
4. The fabric-less path: ``make_model("mlr")`` at its defaults on
   ``cuda``; ``run_clean``, ``run_with_failure`` with
   ``CheckpointPolicy.scar()`` and ``CheckpointPolicy.traditional()``, the
   Theorem 3.2 bound as the quickstart computes it, and the same SCAR run
   on the CPU to hold the card's losses and iteration cost against. Then
   every kernel against its plain version at the MLR leaves' own shapes.
5. The quickstart path (``examples/quickstart.py`` steps 1-2): MLR with
   n=600, dim=64, 5 classes, batch 200, ``run_with_failure`` with
   ``CheckpointPolicy.scar(0.25, 32)`` and ``fabric=FabricConfig()``, held
   against the same run on the CPU (tier counts, iteration cost and
   ``maintain_bytes_moved`` equal, ``applied_sq`` and losses within rtol
   1e-4); then the arena kernels against their plain versions on its
   arenas.
6. The controller at full size, fabric-less: drift steps with PRIORITY 1/8
   partial saves, a failure of half the blocks, PARTIAL recovery held bit
   for bit against the plain restore.
7. The fabric at full size: ``FTController(..., fabric=FabricConfig())`` on
   the 1.54 B tree, drift steps each with a maintain and a partial save,
   then the loss of block 0's primary and replica homes: blocks go to the
   PARITY tier, and the PARITY and PEER_REPLICA blocks come back as their
   live values, bit for bit. Peak device memory is reported.
8. The per-leaf sweep at full size: fused_maintain over all 338 leaves
   under ``FabricConfig()``'s XOR striping (replica and parity bit-exact,
   the parity equal to ``ParityCodec.encode`` of the same tree, scores
   within rtol 1e-4), timed as in phase 2 (the launches alone: the
   parity's memset and the replicas' allocation lie outside the timing);
   then a small tree of bool, f64, int64, complex64 and complex128 leaves,
   whose f32 images the parity holds, one launch per leaf against the
   plain version.
9. gf256_mac at full size, bit-exact against its plain version and timed
   as in phase 2: the RS(4, 2) encode of the arena under the 8-host
   ``FabricConfig(n_devices=8, devices_per_host=1, hosts_per_rack=4,
   rs_parity=2)`` (row 0 equal to parity_xor's encode of the same
   members), the syndrome pass, and a decode of two erasures in every
   group.
10. ``examples/correlated_failures.py``'s multi-erasure section on the
    card: MLR, hosts 0 and 2 lost at step 15, elastic, XOR and RS(k, 2),
    held against the same runs on the CPU (tier counts, fallbacks, iteration
    cost).
11. The RS fabric at full size: ``FTController`` with the 8-host RS(4, 2)
    fabric, drift steps (maintain and save), a clean scrub, an injected bit
    flip found, localized and corrected, then a two-host loss chosen by the
    planner (the first host pair whose plan sends two members of a group to
    PARITY): PARITY and PEER_REPLICA blocks bit-exact, fewer RUNNING_CKPT
    blocks than an XOR fabric on the same topology and loss.
12. The per-leaf fabric at full size: ``FabricConfig(arena=False)``, two
    drift steps, each a maintain (338 fused_maintain launches) and a save,
    then phase 7's loss, the PARITY blocks bit-exact.
13. Launch counts, one set per path: the counts are set to 0 just before
    each of the MLR loops, the quickstart path, the controller, each fabric
    phase and each multi-erasure run, and read just after it. Each path's
    kernels must have launched in it.

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


def in_turns(fns: dict, before=None) -> dict:
    """Median ms of each whole-tree pass, the passes taken in turns.
    ``before()``, when given, runs ahead of every pass, outside its
    timing."""
    import torch
    for fn in fns.values():            # warm-up (allocator, first launch)
        if before is not None:
            before()
        fn()
    torch.cuda.synchronize()
    times = {name: [] for name in fns}
    for _ in range(TIMING_RUNS):
        for name, fn in fns.items():
            if before is not None:
                before()
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


def host_profile(fn, top: int = 12) -> list:
    """Run ``fn`` once under cProfile: the ``top`` functions of this repo by
    cumulative seconds (the host's share of a call that waits on the card
    only where it synchronizes)."""
    import cProfile
    import pstats
    import torch
    prof = cProfile.Profile()
    prof.enable()
    fn()
    torch.cuda.synchronize()
    prof.disable()
    rows = [(f"{Path(file).name}:{line}({name})", st[3])
            for (file, line, name), st in pstats.Stats(prof).stats.items()
            if "repro_torch" in file]
    return [[k, round(s, 4)] for k, s in sorted(rows, key=lambda r: -r[1])
            [:top]]


def bound_ms(n_bytes: float, n_flops: float = 0.0,
             rate: float = F32_FLOPS_PER_S) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def int32_ops_per_s() -> float:
    """The card's 32-bit integer rate: SMs x 64 INT32 lanes x the maximum
    SM clock (``nvidia-smi --query-gpu=clocks.max.sm``)."""
    import torch
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], check=True, capture_output=True,
        text=True, timeout=60)
    mhz = float(out.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * 64 * mhz * 1e6


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
# phase 3: the arena kernels against their plain versions at full size
# ---------------------------------------------------------------------------

def phase_arena_kernels(a_tree, b_tree, device) -> dict:
    """The tree packed into the flat arena (the live arena from ``a``, the
    checkpoint arena from ``b``), with the fabric's default striping."""
    import numpy as np
    import torch
    from repro_torch.core.arena import pack_arena
    from repro_torch.core.blocks import partition_pytree
    from repro_torch.fabric import CheckpointFabric, FabricConfig
    from repro_torch.kernels.fused_maintain.kernel import (arena_maintain_cuda,
                                                           arena_scatter_cuda)
    from repro_torch.kernels.fused_maintain.ops import (save_ranges,
                                                        scatter_plan)
    from repro_torch.kernels.fused_maintain.ref import (arena_maintain_ref,
                                                        arena_scatter_ref)
    from repro_torch.kernels.parity_xor.kernel import parity_xor_cuda
    from repro_torch.kernels.parity_xor.ops import encode_plan
    from repro_torch.kernels.parity_xor.ref import parity_xor_ref

    part = partition_pytree(a_tree, BLOCK_ROWS)
    fab = CheckpointFabric(part, FabricConfig())
    lay, codec = fab.arena_layout, fab.parity
    prog = fab._arena_maintain_fn()
    fe = codec.layout.frame_elems
    log(f"arena: {lay.total_words} words ({lay.nbytes / 1e9:.3f} GB) in "
        f"{lay.n_tiles} tiles, tail {lay.has_tail}; {codec.n_groups} parity "
        f"groups of <= {codec.members.shape[1]}, frame {fe} words, parity "
        f"{codec.n_groups * fe * 4 / 1e9:.3f} GB")
    check(lay.total_words == 1_544_728_576 and not lay.has_tail
          and fe == 1_146_880, "unexpected arena layout at full size")
    x, z = pack_arena(a_tree, lay), pack_arena(b_tree, lay)
    t = prog.plan.on(device)
    n_par = codec.n_groups * fe
    results = {}

    # arena_maintain: parity bit-exact, scores within rtol 1e-4
    par_k = prog.parity_buffer(device).view(-1)
    got = arena_maintain_cuda(x, z, t, par_k, None)
    par_p = torch.zeros((n_par,), dtype=torch.int32, device=device)
    want = arena_maintain_ref(x, z, t, par_p, None)
    check(torch.equal(par_k, par_p), "arena_maintain parity differs")
    rel = ((got - want).abs() / want.abs().clamp_min(1e-30)).max()
    check(float(rel) <= 1e-4, f"arena_maintain scores off by rtol {float(rel)}")
    check(torch.equal(got, arena_maintain_cuda(x, z, t, par_k, None)),
          "arena_maintain scores differ between two runs")
    err = float((got - want).abs().max())
    del par_p
    tm = in_turns({
        "plain": lambda: arena_maintain_ref(x, z, t, par_k, None),
        "kernel": lambda: arena_maintain_cuda(x, z, t, par_k, None)})
    n_dest = int(t["dest_tile"].numel())
    b, by = bound_ms(2 * lay.nbytes + n_dest * 4096 + 4 * part.total_blocks,
                     3 * lay.total_words)
    results["arena_maintain"] = dict(
        max_abs_err=err, ms=tm["kernel"], plain_ms=tm["plain"], bound_ms=b,
        bound_by=by, library_ms=None, dest_tiles=n_dest,
        library_note="no one PyTorch call folds XOR parity and per-block "
                     "squared distances")

    # arena_scatter: a seeded 1/8 of the blocks, bit-exact, into copies
    rng = np.random.default_rng(SEED + 4)
    ids = rng.choice(part.total_blocks, size=part.total_blocks // 8,
                     replace=False)
    off, length = save_ranges(lay, ids)
    moved = lay.seg_bytes_for_blocks(ids)
    check(moved == 4 * int(length.sum()), "the save's ranges are not the "
          "bytes seg_bytes_for_blocks counts")
    st = scatter_plan(off, length, device)
    dst = z.clone()
    arena_scatter_cuda(dst, x, st)
    want_s = arena_scatter_ref(z.clone(), x, st)
    check(torch.equal(dst, want_s), "arena_scatter differs")
    del want_s
    tm = in_turns({"plain": lambda: arena_scatter_ref(dst, x, st),
                   "kernel": lambda: arena_scatter_cuda(dst, x, st)})
    b, by = bound_ms(2 * moved)
    results["arena_scatter"] = dict(
        max_abs_err=0.0, ms=tm["kernel"], plain_ms=tm["plain"], bound_ms=b,
        bound_by=by, library_ms=None, moved_bytes=moved,
        library_note="no one PyTorch call copies selected rows in place "
                     "(a gather and an index_copy_ are two)")
    del dst

    # parity_xor: the whole-arena encode, bit-exact, and equal to the
    # sweep's parity
    plan = encode_plan(lay, codec.layout, codec.members)
    pt = plan.on(device)
    out_k = torch.empty((n_par,), dtype=torch.int32, device=device)
    parity_xor_cuda(out_k, x, None, pt)
    check(torch.equal(out_k, par_k), "parity_xor encode differs from the "
          "arena_maintain parity")
    out_p = parity_xor_ref(torch.empty_like(out_k), x, None, pt)
    check(torch.equal(out_k, out_p), "parity_xor differs")
    del out_p
    tm = in_turns({"plain": lambda: parity_xor_ref(out_k, x, None, pt),
                   "kernel": lambda: parity_xor_cuda(out_k, x, None, pt)})
    b, by = bound_ms(plan.read_bytes + 4 * n_par)
    results["parity_xor"] = dict(
        max_abs_err=0.0, ms=tm["kernel"], plain_ms=tm["plain"], bound_ms=b,
        bound_by=by, library_ms=None,
        library_note="no one PyTorch call XOR-reduces segments in place")
    for name, r in results.items():
        log(f"{name} (whole arena): kernel {r['ms']:.3f} ms, plain "
            f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms "
            f"({r['bound_by']}), library none ({r['library_note']}), max abs "
            f"err {r['max_abs_err']:.3g}")
    return results


# ---------------------------------------------------------------------------
# phase 4: the main path -- the fabric-less SCAR loop on MLR
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
# phase 5: the quickstart path -- the SCAR loop on MLR through the fabric
# ---------------------------------------------------------------------------

QUICKSTART = dict(n=600, dim=64, n_classes=5, batch=200)


def run_quickstart(device) -> dict:
    """``examples/quickstart.py`` steps 1-2 on ``device``."""
    from repro_torch.core.policy import CheckpointPolicy
    from repro_torch.fabric import FabricConfig
    from repro_torch.models.classic import make_model
    from repro_torch.training.classic_runner import run_clean, run_with_failure

    model = make_model("mlr", device=device, **QUICKSTART)
    clean = run_clean(model, max_iters=150, device=device)["losses"]
    res = run_with_failure(model, CheckpointPolicy.scar(fraction=0.25,
                                                        interval=32),
                           fail_iter=25, fail_fraction=0.5, max_iters=150,
                           clean_losses=clean, fabric=FabricConfig(),
                           device=device)
    res["model"] = model
    return res


def check_quickstart_against_cpu(gpu: dict) -> dict:
    """The same run on the CPU (same draws and failure mask): tier counts
    and iteration cost equal, ``applied_sq`` and losses within rtol 1e-4."""
    import numpy as np
    cpu = run_quickstart("cpu")
    check(gpu["recovery"]["tier_counts"] == cpu["recovery"]["tier_counts"],
          "quickstart tier counts differ between the card and the CPU")
    check(gpu["iteration_cost"] == cpu["iteration_cost"],
          "quickstart iteration cost differs between the card and the CPU")
    np.testing.assert_allclose(gpu["recovery"]["applied_sq"],
                               cpu["recovery"]["applied_sq"], rtol=1e-4,
                               atol=1e-12)
    np.testing.assert_allclose(gpu["losses"], cpu["losses"], rtol=1e-4)
    check(gpu["fabric_stats"]["maintain_bytes_moved"]
          == cpu["fabric_stats"]["maintain_bytes_moved"],
          "maintain_bytes_moved differs between the card and the CPU")
    return cpu


def check_fabric_kernels_on_mlr(model, device) -> None:
    """The arena kernels against their plain versions on the quickstart's
    own arena (every leaf tail-packed at 128-row blocks) and at 8-row
    blocks (main tiles and a tail), with seeded values."""
    import numpy as np
    import torch
    from repro_torch.core.arena import pack_arena
    from repro_torch.core.blocks import partition_pytree
    from repro_torch.fabric import CheckpointFabric, FabricConfig
    from repro_torch.kernels.fused_maintain.kernel import (arena_maintain_cuda,
                                                           arena_scatter_cuda)
    from repro_torch.kernels.fused_maintain.ops import (save_ranges,
                                                        scatter_plan)
    from repro_torch.kernels.fused_maintain.ref import (arena_maintain_ref,
                                                        arena_scatter_ref)
    from repro_torch.kernels.parity_xor.kernel import parity_xor_cuda
    from repro_torch.kernels.parity_xor.ops import reconstruct_plan
    from repro_torch.kernels.parity_xor.ref import parity_xor_ref
    from repro_torch.utils.tree import tree_map

    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    shapes = model.init(torch.Generator().manual_seed(1))
    seen = []
    for br in (128, 8):
        part = partition_pytree(shapes, br)
        fab = CheckpointFabric(part, FabricConfig())
        lay, codec = fab.arena_layout, fab.parity
        x, z = (pack_arena(tree_map(lambda v: torch.randn(
            v.shape, generator=gen, device=device), shapes), lay)
            for _ in range(2))
        t = fab._arena_maintain_fn().plan.on(device)
        n_par = codec.n_groups * codec.layout.frame_elems
        pk = torch.zeros((n_par,), dtype=torch.int32, device=device)
        pp = torch.zeros_like(pk)
        rk, rp = torch.zeros_like(x), torch.zeros_like(x)
        sk = arena_maintain_cuda(x, z, t, pk, rk)
        sp = arena_maintain_ref(x, z, t, pp, rp)
        check(torch.equal(pk, pp) and torch.equal(rk, rp),
              f"arena_maintain parity or replica differs (block_rows {br})")
        check(bool(torch.all((sk - sp).abs() <= 1e-4 * sp.abs())),
              f"arena_maintain scores differ (block_rows {br})")
        st = scatter_plan(*save_ranges(lay, np.arange(0, part.total_blocks,
                                                      2)), device)
        check(torch.equal(arena_scatter_cuda(z.clone(), x, st),
                          arena_scatter_ref(z.clone(), x, st)),
              f"arena_scatter differs (block_rows {br})")
        lost = np.zeros((part.total_blocks,), bool)
        lost[codec.members[0][0]] = True
        keep = codec.valid & ~lost[np.where(codec.valid, codec.members, 0)]
        plan, _ = reconstruct_plan(lay, codec.layout, codec.group_of,
                                   codec.members, np.nonzero(lost)[0], keep)
        pt = plan.on(device)
        out = torch.empty((plan.out_words,), dtype=torch.int32, device=device)
        check(torch.equal(parity_xor_cuda(out, x, pk, pt),
                          parity_xor_ref(out.clone(), x, pk, pt)),
              f"parity_xor differs (block_rows {br})")
        seen.append(f"block_rows {br}: {part.total_blocks} blocks, "
                    f"{lay.n_tiles} tiles, tail {lay.has_tail}")
    log(f"arena kernels agree with their plain versions on the quickstart "
        f"MLR arenas: {'; '.join(seen)}")


# ---------------------------------------------------------------------------
# phase 6: the controller at full size, fabric-less
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


# ---------------------------------------------------------------------------
# phase 7: the fabric at full size
# ---------------------------------------------------------------------------

def phase_fabric(tree, device) -> dict:
    """``FTController`` with ``FabricConfig()`` on the 1.54 B tree: seeded
    drift steps, each a maintain (one arena sweep) and a PRIORITY 1/8
    partial save (one arena scatter), the last under the profiler, then
    the loss of block 0's primary home and its replica home, which sends
    blocks to the PARITY tier (timed, then run again under the profiler
    and under cProfile)."""
    import numpy as np
    import torch
    from repro_torch.core.controller import FTController
    from repro_torch.core.policy import CheckpointPolicy, SelectionStrategy
    from repro_torch.fabric import FabricConfig
    from repro_torch.utils.tree import tree_leaves

    torch.cuda.reset_peak_memory_stats()
    policy = CheckpointPolicy(fraction=0.125, full_interval=8,
                              strategy=SelectionStrategy.PRIORITY,
                              block_rows=BLOCK_ROWS)
    t0 = time.perf_counter()
    ctl = FTController(tree, policy, fabric=FabricConfig())
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    check(ctl.arena_ready, "the full-size controller is not in arena mode")
    fab, part = ctl.fabric, ctl.partition
    gen = torch.Generator(device=device).manual_seed(SEED + 6)
    maint_s, save_s = [], []
    steps = 3
    for step in range(1, steps + 1):
        for x in tree_leaves(tree):
            x.add_(torch.randn(x.shape, generator=gen, device=device),
                   alpha=1e-3)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ctl.maintain(step, tree)
        fab.block_until_maintained()
        maint_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        check(ctl.maybe_checkpoint(step, tree), f"no save at step {step}")
        save_s.append(time.perf_counter() - t0)
    k = part.blocks_for_k(policy.fraction)
    check(ctl.stats["blocks_saved"] == steps * k, "wrong number of blocks")
    # one more step under the profiler: a maintain, then a save
    for x in tree_leaves(tree):
        x.add_(torch.randn(x.shape, generator=gen, device=device), alpha=1e-3)
    steps += 1
    profiled_maintain = device_share(lambda: ctl.maintain(steps, tree))
    profiled_save = device_share(lambda: ctl.maybe_checkpoint(steps, tree))
    log(f"one maintain at 1.54 B under the profiler: "
        f"{json.dumps(profiled_maintain)}")
    log(f"one arena save at 1.54 B under the profiler: "
        f"{json.dumps(profiled_save)}")
    for x in tree_leaves(tree):
        x.add_(torch.randn(x.shape, generator=gen, device=device), alpha=1e-3)
    steps += 1
    host = host_profile(lambda: (ctl.maintain(steps, tree),
                                 ctl.maybe_checkpoint(steps, tree)))
    log(f"one maintain and save at 1.54 B, host time by function (cProfile, "
        f"cumulative s): {json.dumps(host)}")
    failed = np.unique(np.asarray([fab.view.homes[0],
                                   fab.replicas.replica_homes[0]], np.int32))
    lost = np.isin(fab.view.homes, failed)
    plan = fab.planner.plan(lost, failed, steps)

    def recover():
        return ctl.on_failure(tree, lost, failed_devices=failed, step=steps)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    recovered, info = recover()
    torch.cuda.synchronize()
    recovery_s = time.perf_counter() - t0
    # the same recovery again (the view keeps no failure: elastic is off),
    # once under the profiler and once under cProfile for the host's share
    profiled_recovery = device_share(recover)
    log(f"the recovery under the profiler: {json.dumps(profiled_recovery)}")
    log(f"the recovery's host time by function (cProfile, cumulative s): "
        f"{json.dumps(host_profile(recover))}")
    counts = info["tier_counts"]
    check(counts == plan.counts, "the recovery did not follow its plan")
    check(counts["PARITY"] > 0, f"no block went to the PARITY tier: {counts}")
    check(info["tier_sq"]["PARITY"] == 0.0
          and info["tier_sq"]["PEER_REPLICA"] == 0.0,
          f"live-value tiers perturbed the state: {info['tier_sq']}")
    live_tiers = plan.mask(1) | plan.mask(2)      # PEER_REPLICA, PARITY
    for x, r, leaf in zip(tree_leaves(tree), tree_leaves(recovered),
                          part.leaves):
        m = live_tiers[leaf.offset:leaf.offset + leaf.n_blocks]
        rows = np.repeat(m, BLOCK_ROWS)[:leaf.rows]
        if rows.any():
            sel = torch.from_numpy(rows).to(device)
            check(torch.equal(r.reshape(leaf.rows, -1)[sel],
                              x.reshape(leaf.rows, -1)[sel]),
                  f"{leaf.name}: a PEER_REPLICA or PARITY block is not its "
                  f"live value")
    out = {"setup_seconds": setup_s,
           "maintain_seconds": maint_s, "save_seconds": save_s,
           "recovery_seconds": recovery_s, "blocks_per_save": k,
           "save_bytes_moved": ctl.stats["save_bytes_moved"],
           "maintain_bytes_moved": fab.stats["maintain_bytes_moved"],
           "failed_devices": failed.tolist(),
           "lost_blocks": info["lost_blocks"], "tier_counts": counts,
           "tier_sq": info["tier_sq"], "applied_sq": info["applied_sq"],
           "parity_groups": fab.parity.n_groups,
           "profiled_maintain": profiled_maintain,
           "profiled_save": profiled_save,
           "profiled_recovery": profiled_recovery,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    check(out["peak_memory_gb"] < 70, f"peak device memory "
          f"{out['peak_memory_gb']:.1f} GB")
    log(f"fabric at 1.54 B values: {json.dumps(out)}")
    return out


# ---------------------------------------------------------------------------
# phase 8: the per-leaf sweep at full size
# ---------------------------------------------------------------------------

def phase_leaf_kernel(a_tree, b_tree, device) -> dict:
    """fused_maintain over every leaf of the tree (``a`` live, ``b`` the
    checkpoint) under ``FabricConfig()``'s XOR striping, one launch per
    leaf, against its plain version leaf by leaf."""
    import torch
    from repro_torch.core.blocks import partition_pytree
    from repro_torch.fabric import CheckpointFabric, FabricConfig
    from repro_torch.kernels.fused_maintain import ops
    from repro_torch.kernels.fused_maintain.kernel import fused_maintain_cuda
    from repro_torch.kernels.fused_maintain.ref import fused_maintain_ref
    from repro_torch.utils.tree import tree_leaves

    part = partition_pytree(a_tree, BLOCK_ROWS)
    fab = CheckpointFabric(part, FabricConfig(arena=False))
    codec = fab.parity
    fe = codec.layout.frame_elems
    metas = ops.leaf_group_metas(part, codec.layout, codec.group_of)
    tables = [ops.leaf_tables(m, l.n_blocks, device)
              for m, l in zip(metas, part.leaves)]
    xs, zs = tree_leaves(a_tree), tree_leaves(b_tree)
    n_par = codec.n_groups * fe
    log(f"per-leaf sweep: {len(xs)} leaves, {codec.n_groups} groups of <= "
        f"{codec.members.shape[1]}, parity {n_par * 4 / 1e9:.3f} GB")

    def sweep(fn, par):
        par.zero_()
        return [fn(x, z, par, t, BLOCK_ROWS, m.col, fe)
                for x, z, t, m in zip(xs, zs, tables, metas)]

    par_k = torch.empty((n_par,), dtype=torch.int32, device=device)
    got = sweep(fused_maintain_cuda, par_k)
    par_p = torch.empty_like(par_k)
    want = sweep(fused_maintain_ref, par_p)
    check(torch.equal(par_k, par_p), "fused_maintain parity differs")
    err = 0.0
    for (rk, sk), (rp, sp), x in zip(got, want, xs):
        check(torch.equal(rk, rp) and torch.equal(rk, x),
              "fused_maintain replica differs")
        rel = ((sk - sp).abs() / sp.abs().clamp_min(1e-30)).max()
        check(float(rel) <= 1e-4, f"fused_maintain scores off by rtol "
              f"{float(rel)}")
        err = max(err, float((sk - sp).abs().max()))
    again = sweep(fused_maintain_cuda, par_k)
    check(all(torch.equal(a[1], g[1]) for a, g in zip(again, got)),
          "fused_maintain scores differ between two runs")
    del got, want, again, par_p
    codec.encode(0, a_tree)
    check(torch.equal(codec.parity.view(-1), par_k),
          "fused_maintain parity differs from ParityCodec.encode")
    codec.parity = None
    torch.cuda.empty_cache()
    # timed: the launches alone, into replicas allocated and a parity
    # zeroed outside the timing (the memset of the whole parity is the
    # fabric's, once per maintain, and not this kernel's work)
    reps = [torch.empty_like(x) for x in xs]

    def launches(fn):
        return [fn(x, z, par_k, t, BLOCK_ROWS, m.col, fe, r)
                for x, z, t, m, r in zip(xs, zs, tables, metas, reps)]

    tm = in_turns({"plain": lambda: launches(fused_maintain_ref),
                   "kernel": lambda: launches(fused_maintain_cuda)},
                  before=par_k.zero_)
    del reps
    touched = sum(int(m.touched.size) * m.width for m in metas)
    n_bytes = sum(3 * x.numel() * x.element_size() for x in xs) \
        + 2 * 4 * touched + 4 * part.total_blocks
    b, by = bound_ms(n_bytes, 3 * sum(x.numel() for x in xs))
    r = dict(max_abs_err=err, ms=tm["kernel"], plain_ms=tm["plain"],
             bound_ms=b, bound_by=by, library_ms=None, launches_per_pass=
             len(xs), library_note="no one PyTorch call folds the replica, "
             "the scores and the XOR parity")
    log(f"fused_maintain (338 leaves): kernel {r['ms']:.3f} ms, plain "
        f"{r['plain_ms']:.3f} ms, bound {b:.3f} ms ({by}), library none "
        f"({r['library_note']}), max abs err {err:.3g}")
    image_loaders(device)
    return {"fused_maintain": r}


def image_loaders(device) -> None:
    """The per-leaf sweep of a small tree of bool, f64, int64 and complex
    leaves (the parity holds their f32 images), on the card against the
    plain version: one launch per leaf, replicas and parity bit-exact,
    scores rtol 1e-4."""
    import torch
    from repro_torch.core.blocks import partition_pytree
    from repro_torch.fabric import CheckpointFabric, FabricConfig
    from repro_torch.kernels import _build
    from repro_torch.kernels.fused_maintain.ops import make_fused_maintain_fn
    from repro_torch.utils.tree import tree_map

    def tree(seed):
        gen = torch.Generator().manual_seed(seed)
        return {"d": torch.randn(300, 70, generator=gen, dtype=torch.float64),
                "i": torch.randint(-2**40, 2**40, (190, 50), generator=gen),
                "m": torch.rand(130, 90, generator=gen) > 0.5,
                "c": torch.randn(210, 30, generator=gen,
                                 dtype=torch.complex64),
                "k": torch.randn(90, 40, generator=gen,
                                 dtype=torch.complex128)}

    x, z = tree(SEED + 7), tree(SEED + 8)
    part = partition_pytree(x, BLOCK_ROWS)
    codec = CheckpointFabric(part, FabricConfig(arena=False)).parity
    fn = make_fused_maintain_fn(part, codec.layout, codec.group_of,
                                codec.n_groups)
    n0 = _build.LAUNCHES["fused_maintain"]
    rep_k, sc_k, par_k = fn(tree_map(lambda v: v.to(device), x),
                            tree_map(lambda v: v.to(device), z))
    torch.cuda.synchronize()
    check(_build.LAUNCHES["fused_maintain"] - n0 == len(x),
          "fused_maintain did not launch once per bool/f64/int64/complex "
          "leaf")
    rep_p, sc_p, par_p = fn(x, z)
    check(torch.equal(par_k.cpu(), par_p)
          and all(torch.equal(rep_k[k].cpu(), x[k]) for k in x),
          "fused_maintain differs from its plain version on f32-image "
          "dtypes")
    rel = float(((sc_k.cpu() - sc_p).abs()
                 / sc_p.abs().clamp_min(1e-30)).max())
    check(rel <= 1e-4, f"fused_maintain f32-image scores off by rtol {rel}")
    log(f"fused_maintain on bool/f64/int64/complex64/complex128 leaves: "
        f"bit-exact, scores rtol {rel:.3g}")


# ---------------------------------------------------------------------------
# phase 9: gf256_mac at full size
# ---------------------------------------------------------------------------

RS_FABRIC = dict(n_devices=8, devices_per_host=1, hosts_per_rack=4,
                 rs_parity=2)


def phase_rs_kernels(a_tree, device, int_rate: float) -> dict:
    """The RS(4, 2) codec of the 8-host fabric over the packed tree: the
    encode, the syndrome pass over a flipped word, and a decode of two
    erasures in every group, each against the plain version."""
    import numpy as np
    import torch
    from repro_torch.core.arena import pack_arena
    from repro_torch.core.blocks import partition_pytree
    from repro_torch.fabric import CheckpointFabric, FabricConfig
    from repro_torch.kernels.gf256_mac.kernel import gf256_mac_cuda
    from repro_torch.kernels.gf256_mac.ref import gf256_mac_plan_ref
    from repro_torch.kernels.parity_xor.kernel import parity_xor_cuda
    from repro_torch.kernels.parity_xor.ops import encode_plan

    part = partition_pytree(a_tree, BLOCK_ROWS)
    fab = CheckpointFabric(part, FabricConfig(**RS_FABRIC))
    lay, codec = fab.arena_layout, fab.parity
    m, fe = codec.n_parity, codec.layout.frame_elems
    enc, syn = codec.gf_plans(lay)
    n_out = codec.n_groups * m * fe
    log(f"RS({codec.group_size}, {m}) over {fab.domains.n_hosts} hosts: "
        f"{codec.n_groups} groups of <= {codec.members.shape[1]}, rows "
        f"{n_out * 4 / 1e9:.3f} GB")
    x = pack_arena(a_tree, lay)
    results = {}

    def plain(out, src, src2, base, plan):
        return gf256_mac_plan_ref(out, src, src2, base, plan.on(device), 0,
                                  plan.n_rows, 0)

    # the encode: bit-exact, row 0 equal to parity_xor's encode
    rows_k = torch.empty((n_out,), dtype=torch.int32, device=device)
    gf256_mac_cuda(rows_k, x, None, None, enc)
    rows_p = plain(torch.empty_like(rows_k), x, None, None, enc)
    check(torch.equal(rows_k, rows_p), "gf256_mac encode differs")
    del rows_p
    xor = torch.empty((codec.n_groups * fe,), dtype=torch.int32,
                      device=device)
    parity_xor_cuda(xor, x, None, encode_plan(lay, codec.layout,
                                              codec.members).on(device))
    check(torch.equal(rows_k.view(codec.n_groups, m, fe)[:, 0],
                      xor.view(codec.n_groups, fe)),
          "RS row 0 differs from parity_xor's encode of the same members")
    del xor
    tm = in_turns({"plain": lambda: plain(rows_k, x, None, None, enc),
                   "kernel": lambda: gf256_mac_cuda(rows_k, x, None, None,
                                                    enc)})
    b, by = bound_ms(enc.read_bytes() + enc.write_bytes(), enc.int_ops(),
                     int_rate)
    results["encode"] = dict(ms=tm["kernel"], plain_ms=tm["plain"],
                             bound_ms=b, bound_by=by, int_ops=enc.int_ops(),
                             groups=codec.n_groups)

    # the syndrome pass over an arena with one word flipped
    word = int(lay.blocks[len(lay.blocks) // 2].offset) + 5
    x[word] ^= 1 << 11
    synd = torch.empty_like(rows_k)
    gf256_mac_cuda(synd, x, None, rows_k, syn)
    per = m * fe
    batch = 100
    for g0 in range(0, codec.n_groups, batch):
        nb = min(batch, codec.n_groups - g0)
        want = gf256_mac_plan_ref(
            torch.empty((nb * per,), dtype=torch.int32, device=device), x,
            None, rows_k, syn.on(device), g0, nb, g0 * per)
        check(torch.equal(synd[g0 * per:(g0 + nb) * per], want),
              "gf256_mac syndromes differ")
    flagged = torch.nonzero(synd.view(codec.n_groups, per).ne(0).any(1))
    check(flagged.numel() == 1, f"{flagged.numel()} groups flagged, not 1")
    tm = in_turns({"plain": lambda: plain(synd, x, None, rows_k, syn),
                   "kernel": lambda: gf256_mac_cuda(synd, x, None, rows_k,
                                                    syn)})
    del synd
    x[word] ^= 1 << 11
    b, by = bound_ms(syn.read_bytes() + syn.write_bytes(), syn.int_ops(),
                     int_rate)
    results["syndromes"] = dict(ms=tm["kernel"], plain_ms=tm["plain"],
                                bound_ms=b, bound_by=by,
                                int_ops=syn.int_ops())

    # a decode of two erasures in every group of >= 2 members
    codec.parity = rows_k.view(codec.n_groups, m, fe)
    codec.encoded_step = 0
    lost = np.zeros((part.total_blocks,), bool)
    for row in codec.members:
        ids = row[row >= 0]
        if ids.size >= 2:
            lost[ids[:2]] = True
    t0 = time.perf_counter()
    dec, blocks = codec.decode_plan(lay, lost, ~lost)
    plan_s = time.perf_counter() - t0
    n_dec = int(dec.row_len.astype(np.int64).sum())
    out_k = torch.empty((n_dec,), dtype=torch.int32, device=device)
    gf256_mac_cuda(out_k, x, rows_k, None, dec)
    out_p = plain(torch.empty_like(out_k), x, rows_k, None, dec)
    check(torch.equal(out_k, out_p), "gf256_mac decode differs")
    del out_p
    ab = lay.ab_arrays()
    want = torch.cat([x[int(ab["offset"][a]):int(ab["offset"][a])
                        + int(ab["payload"][a])] for a in blocks])
    check(torch.equal(out_k, want), "the decode is not the lost words")
    del want
    tm = in_turns({"plain": lambda: plain(out_k, x, rows_k, None, dec),
                   "kernel": lambda: gf256_mac_cuda(out_k, x, rows_k, None,
                                                    dec)})
    b, by = bound_ms(dec.read_bytes() + dec.write_bytes(), dec.int_ops(),
                     int_rate)
    results["decode"] = dict(ms=tm["kernel"], plain_ms=tm["plain"],
                             bound_ms=b, bound_by=by, int_ops=dec.int_ops(),
                             blocks=int(lost.sum()), plan_seconds=plan_s)
    for name, r in results.items():
        log(f"gf256_mac {name}: kernel {r['ms']:.3f} ms, plain "
            f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms "
            f"({r['bound_by']}; {r['int_ops']:.4g} int32 operations at "
            f"{int_rate / 1e12:.2f} T/s), library none (no one PyTorch call "
            f"does a GF(256) multiply-accumulate), max abs err 0")
    codec.parity = None
    del rows_k, x
    torch.cuda.empty_cache()
    e = results["encode"]
    return {"gf256_mac": dict(
        max_abs_err=0.0, ms=e["ms"], plain_ms=e["plain_ms"],
        bound_ms=e["bound_ms"], bound_by=e["bound_by"], library_ms=None,
        shapes=results)}


# ---------------------------------------------------------------------------
# phase 10: examples/correlated_failures.py's multi-erasure section
# ---------------------------------------------------------------------------

def run_multi_erasure(device, rs: bool) -> dict:
    """Hosts 0 and 2 lost at step 15 of the example's MLR soak."""
    from repro_torch.core.policy import (CheckpointPolicy, RecoveryMode,
                                         SelectionStrategy)
    from repro_torch.fabric import FabricConfig, FailureEvent
    from repro_torch.models.classic import make_model
    from repro_torch.training.classic_runner import run_clean, run_with_trace

    model = make_model("mlr", device=device, **QUICKSTART)
    clean = run_clean(model, 120, device=device)["losses"]
    policy = CheckpointPolicy(fraction=0.25, full_interval=8,
                              strategy=SelectionStrategy.ROUND_ROBIN,
                              recovery=RecoveryMode.PARTIAL,
                              block_rows=model.block_rows)
    r = run_with_trace(
        model, policy, max_iters=120, seed=0, clean_losses=clean,
        trace=[FailureEvent(step=15, kind="host", index=0),
               FailureEvent(step=15, kind="host", index=2)],
        fabric=FabricConfig(n_devices=8, devices_per_host=2,
                            hosts_per_rack=2, elastic=True,
                            rs_parity=2 if rs else 0), device=device)
    ev = next(e for e in r["events"] if not e.get("skipped"))
    return {"iteration_cost": r["iteration_cost"],
            "tier_counts": ev["tier_counts"],
            "fallbacks": len(ev.get("tier_fallbacks", [])),
            "applied_sq": ev["applied_sq"]}


# ---------------------------------------------------------------------------
# phases 11 and 12: the RS fabric and the per-leaf fabric at full size
# ---------------------------------------------------------------------------

def _drift(tree, gen, device) -> None:
    import torch
    from repro_torch.utils.tree import tree_leaves
    for x in tree_leaves(tree):
        x.add_(torch.randn(x.shape, generator=gen, device=device), alpha=1e-3)


def _drive(ctl, tree, gen, device, steps: int) -> tuple[list, list]:
    """Drift steps, each a maintain and a PRIORITY save: their seconds."""
    import torch
    maint_s, save_s = [], []
    for step in range(1, steps + 1):
        _drift(tree, gen, device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ctl.maintain(step, tree)
        ctl.fabric.block_until_maintained()
        maint_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        check(ctl.maybe_checkpoint(step, tree), f"no save at step {step}")
        save_s.append(time.perf_counter() - t0)
    return maint_s, save_s


def _check_live_tiers(tree, recovered, plan, part, device) -> None:
    """PEER_REPLICA and PARITY blocks came back as their live values."""
    import numpy as np
    import torch
    from repro_torch.utils.tree import tree_leaves
    live_tiers = plan.mask(1) | plan.mask(2)
    for x, r, leaf in zip(tree_leaves(tree), tree_leaves(recovered),
                          part.leaves):
        m = live_tiers[leaf.offset:leaf.offset + leaf.n_blocks]
        rows = np.repeat(m, BLOCK_ROWS)[:leaf.rows]
        if rows.any():
            sel = torch.from_numpy(rows).to(device)
            check(torch.equal(r.reshape(leaf.rows, -1)[sel],
                              x.reshape(leaf.rows, -1)[sel]),
                  f"{leaf.name}: a PEER_REPLICA or PARITY block is not its "
                  f"live value")


def _saving_policy():
    from repro_torch.core.policy import CheckpointPolicy, SelectionStrategy
    return CheckpointPolicy(fraction=0.125, full_interval=8,
                            strategy=SelectionStrategy.PRIORITY,
                            block_rows=BLOCK_ROWS)


def phase_rs_fabric(tree, device) -> dict:
    import itertools
    import numpy as np
    import torch
    from repro_torch.core.controller import FTController
    from repro_torch.fabric import CheckpointFabric, FabricConfig

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ctl = FTController(tree, _saving_policy(),
                       fabric=FabricConfig(**RS_FABRIC))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    fab, part = ctl.fabric, ctl.partition
    check(ctl.arena_ready, "the RS controller is not in arena mode")
    gen = torch.Generator(device=device).manual_seed(SEED + 7)
    steps = 3
    maint_s, save_s = _drive(ctl, tree, gen, device, steps)
    check(fab.stats["rs_arena_encodes"] == steps, "no RS encode per maintain")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    clean = ctl.scrub(step=steps)
    clean_s = time.perf_counter() - t0
    check(clean["checked"] and clean["detected"] == 0,
          f"the clean scrub found something: {clean}")
    before = fab.replicas.arena.clone()
    where = fab.inject_arena_bit_flip(rng=np.random.default_rng(SEED + 8))
    check(not torch.equal(before, fab.replicas.arena), "no bit flipped")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = ctl.scrub(step=steps)
    torch.cuda.synchronize()
    flip_s = time.perf_counter() - t0
    check(out["detected"] == 1 and out["corrected"] == 1
          and out["reports"][0]["block"] == where["block"],
          f"the flip at {where} was not corrected: {out}")
    check(torch.equal(before, fab.replicas.arena),
          "the replica arena differs from before the flip")
    del before
    # the first host pair whose plan sends two members of a group to PARITY
    codec = fab.parity
    pair = None
    for h0, h1 in itertools.combinations(range(fab.domains.n_hosts), 2):
        l0, f0 = fab.domain_failure("host", h0)
        l1, f1 = fab.domain_failure("host", h1)
        lost, failed = l0 | l1, np.unique(np.concatenate([f0, f1]))
        plan = fab.planner.plan(lost, failed, steps)
        par = codec.member_mask(plan.mask(2))
        if (par.sum(axis=1) >= 2).any():
            pair = (h0, h1)
            break
    check(pair is not None, "no host pair erases two members of a group")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    recovered, info = ctl.on_failure(tree, lost, failed_devices=failed,
                                     step=steps)
    torch.cuda.synchronize()
    recovery_s = time.perf_counter() - t0
    counts = info["tier_counts"]
    check(counts == plan.counts, "the recovery did not follow its plan")
    check(info["tier_sq"]["PARITY"] == 0.0
          and info["tier_sq"]["PEER_REPLICA"] == 0.0,
          f"live-value tiers perturbed the state: {info['tier_sq']}")
    _check_live_tiers(tree, recovered, plan, part, device)
    peak = torch.cuda.max_memory_allocated() / 1e9
    del recovered
    stats = dict(fab.stats)
    groups = codec.n_groups
    del ctl, fab, codec
    torch.cuda.empty_cache()
    # the same loss under an XOR fabric on the same topology
    xor = CheckpointFabric(part, FabricConfig(
        **{k: v for k, v in RS_FABRIC.items() if k != "rs_parity"}))
    xor.maintain(steps, tree)
    xor_counts = xor.planner.plan(lost, failed, steps).counts
    del xor
    torch.cuda.empty_cache()
    check(counts["RUNNING_CKPT"] < xor_counts["RUNNING_CKPT"],
          f"RS sent {counts['RUNNING_CKPT']} blocks to RUNNING_CKPT, XOR "
          f"{xor_counts['RUNNING_CKPT']}")
    out = {"setup_seconds": setup_s, "maintain_seconds": maint_s,
           "save_seconds": save_s, "clean_scrub_seconds": clean_s,
           "flip_scrub_seconds": flip_s, "flip": where,
           "recovery_seconds": recovery_s, "hosts": list(pair),
           "failed_devices": failed.tolist(),
           "lost_blocks": info["lost_blocks"], "tier_counts": counts,
           "xor_tier_counts": xor_counts, "tier_sq": info["tier_sq"],
           "parity_groups": groups, "peak_memory_gb": peak,
           "fabric_stats": {k: stats[k] for k in (
               "rs_arena_encodes", "scrubs", "silent_errors_detected",
               "silent_errors_corrected", "maintain_bytes_moved")}}
    check(peak < 70, f"peak device memory {peak:.1f} GB")
    log(f"RS fabric at 1.54 B values: {json.dumps(out)}")
    return out


def phase_leaf_fabric(tree, device) -> dict:
    import numpy as np
    import torch
    from repro_torch.core.controller import FTController
    from repro_torch.fabric import FabricConfig
    from repro_torch.kernels import _build

    torch.cuda.reset_peak_memory_stats()
    ctl = FTController(tree, _saving_policy(),
                       fabric=FabricConfig(arena=False))
    fab, part = ctl.fabric, ctl.partition
    check(not ctl.arena_ready and fab.arena_layout is None,
          "the arena=False controller is in arena mode")
    gen = torch.Generator(device=device).manual_seed(SEED + 9)
    steps = 2
    n0 = _build.LAUNCHES["fused_maintain"]
    maint_s, save_s = _drive(ctl, tree, gen, device, steps)
    check(_build.LAUNCHES["fused_maintain"] - n0 == steps * len(part.leaves),
          "not one fused_maintain launch per leaf and maintain")
    failed = np.unique(np.asarray([fab.view.homes[0],
                                   fab.replicas.replica_homes[0]], np.int32))
    lost = np.isin(fab.view.homes, failed)
    plan = fab.planner.plan(lost, failed, steps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    recovered, info = ctl.on_failure(tree, lost, failed_devices=failed,
                                     step=steps)
    torch.cuda.synchronize()
    recovery_s = time.perf_counter() - t0
    counts = info["tier_counts"]
    check(counts == plan.counts, "the recovery did not follow its plan")
    check(counts["PARITY"] > 0, f"no block went to the PARITY tier: {counts}")
    check(info["tier_sq"]["PARITY"] == 0.0
          and info["tier_sq"]["PEER_REPLICA"] == 0.0,
          f"live-value tiers perturbed the state: {info['tier_sq']}")
    _check_live_tiers(tree, recovered, plan, part, device)
    out = {"maintain_seconds": maint_s, "save_seconds": save_s,
           "recovery_seconds": recovery_s, "failed_devices": failed.tolist(),
           "lost_blocks": info["lost_blocks"], "tier_counts": counts,
           "parity_groups": fab.parity.n_groups,
           "maintain_bytes_moved": fab.stats["maintain_bytes_moved"],
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    check(out["peak_memory_gb"] < 70, f"peak device memory "
          f"{out['peak_memory_gb']:.1f} GB")
    log(f"per-leaf fabric at 1.54 B values: {json.dumps(out)}")
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
    int_rate = int32_ops_per_s()
    log(f"INT32 rate: {int_rate / 1e12:.3f} T operations/s "
        f"({torch.cuda.get_device_properties(0).multi_processor_count} SMs "
        f"x 64 lanes x the maximum SM clock)")
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
    log(f"peak device memory after phase 2: "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    kernels.update(phase_arena_kernels(a_tree, b_tree, device))
    kernels.update(phase_leaf_kernel(a_tree, b_tree, device))
    del b_tree
    torch.cuda.empty_cache()
    kernels.update(phase_rs_kernels(a_tree, device, int_rate))
    log(f"peak device memory after phase 9: "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

    # each path's own launch counts: set to 0 just before it, read just
    # after it; the kernel-against-plain checks run outside every window
    launches = {}
    _build.reset_launches()
    mlr = phase_mlr(device)
    launches["mlr"] = dict(_build.LAUNCHES)
    check_mlr_against_cpu(mlr)
    check_kernels_on_mlr(mlr["model"], device)
    _build.reset_launches()
    t0 = time.perf_counter()
    quick = run_quickstart(device)
    quick_s = time.perf_counter() - t0
    launches["mlr_fabric"] = dict(_build.LAUNCHES)
    quick_cpu = check_quickstart_against_cpu(quick)
    check_fabric_kernels_on_mlr(quick["model"], device)
    log(f"quickstart path on {device}: iteration cost "
        f"{quick['iteration_cost']} (CPU {quick_cpu['iteration_cost']}), "
        f"recovery {json.dumps(quick['recovery'])}, maint_seconds_per_iter "
        f"{quick['maint_seconds_per_iter']:.6f} (CPU "
        f"{quick_cpu['maint_seconds_per_iter']:.6f}), fabric_stats "
        f"{json.dumps(quick['fabric_stats'])}, {quick_s:.2f} s")
    multi = {}
    for rs in (False, True):
        path = "mlr_rs" if rs else "mlr_xor"
        _build.reset_launches()
        multi[path] = run_multi_erasure(device, rs)
        launches[path] = dict(_build.LAUNCHES)
        cpu = run_multi_erasure("cpu", rs)
        check(multi[path]["tier_counts"] == cpu["tier_counts"]
              and multi[path]["fallbacks"] == cpu["fallbacks"]
              and multi[path]["iteration_cost"] == cpu["iteration_cost"],
              f"{path}: the card {multi[path]} and the CPU {cpu} differ")
        multi[path]["cpu"] = cpu
    check(multi["mlr_rs"]["fallbacks"] == 0
          and multi["mlr_rs"]["tier_counts"]["RUNNING_CKPT"] == 0
          and multi["mlr_xor"]["fallbacks"] > 0,
          f"RS(k, 2) did not absorb the double loss: {multi}")
    log(f"multi-erasure section on {device}: {json.dumps(multi)}")
    _build.reset_launches()
    ctl = phase_controller(a_tree, device)
    launches["controller"] = dict(_build.LAUNCHES)
    _build.reset_launches()
    fabric = phase_fabric(a_tree, device)
    launches["fabric"] = dict(_build.LAUNCHES)
    torch.cuda.empty_cache()
    _build.reset_launches()
    rs_fabric = phase_rs_fabric(a_tree, device)
    launches["rs_fabric"] = dict(_build.LAUNCHES)
    _build.reset_launches()
    leaf_fabric = phase_leaf_fabric(a_tree, device)
    launches["leaf_fabric"] = dict(_build.LAUNCHES)
    log(json.dumps({"launches": launches}))
    old = ("block_dist", "scatter_save", "masked_restore")
    new = ("arena_maintain", "arena_scatter", "parity_xor")
    for path, names in (("mlr", old), ("controller", old),
                        ("mlr_fabric", new[:2]), ("fabric", new),
                        ("mlr_rs", ("gf256_mac",)),
                        ("rs_fabric", ("arena_maintain", "arena_scatter",
                                       "gf256_mac", "masked_restore")),
                        ("leaf_fabric", ("fused_maintain", "scatter_save",
                                         "parity_xor", "masked_restore"))):
        for name in names:
            check(launches[path][name] > 0,
                  f"{name} was not launched on the {path} path")
    log(f"peak device memory: {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

    sources = {
        "block_dist": ("src/repro_torch/csrc/block_dist.cu",
                       "src/repro/kernels/block_dist/kernel.py:41", "mlr"),
        "scatter_save": ("src/repro_torch/csrc/scatter_save.cu",
                         "src/repro/kernels/fused_maintain/kernel.py:245",
                         "mlr"),
        "masked_restore": ("src/repro_torch/csrc/masked_restore.cu",
                           "src/repro/kernels/masked_restore/kernel.py:31",
                           "mlr"),
        "arena_maintain": ("src/repro_torch/csrc/arena_maintain.cu",
                           "src/repro/kernels/fused_maintain/kernel.py:153",
                           "fabric"),
        "arena_scatter": ("src/repro_torch/csrc/arena_scatter.cu",
                          "src/repro/kernels/fused_maintain/kernel.py:211",
                          "fabric"),
        "parity_xor": ("src/repro_torch/csrc/parity_xor.cu",
                       "src/repro/kernels/parity_xor/kernel.py:42",
                       "fabric"),
        "fused_maintain": ("src/repro_torch/csrc/fused_maintain.cu",
                           "src/repro/kernels/fused_maintain/kernel.py:70",
                           "leaf_fabric"),
        "gf256_mac": ("src/repro_torch/csrc/gf256_mac.cu",
                      "src/repro/kernels/gf256_mac/kernel.py:65",
                      "rs_fabric")}
    record = []
    for name, (source, replaces, path) in sources.items():
        r = kernels[name]
        record.append({"name": name, "route": "cuda", "source": source,
                       "replaces": replaces, "launches": launches[path][name],
                       "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                       "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                       "bound_by": r["bound_by"],
                       "library_ms": r["library_ms"]})
    log(json.dumps({"controller": ctl, "fabric": fabric,
                    "rs_fabric": rs_fabric, "leaf_fabric": leaf_fabric,
                    "multi_erasure": multi,
                    "gf256_mac_shapes": kernels["gf256_mac"]["shapes"],
                    "int32_ops_per_s": int_rate, "mlr": {
        "kappa_clean": mlr["kappa"],
        "scar_iteration_cost": mlr["scar"]["iteration_cost"],
        "traditional_iteration_cost": mlr["trad"]["iteration_cost"],
        "bound": mlr["bound"], "profiled_scar_run": mlr["profile"]},
        "quickstart": {
            "iteration_cost": quick["iteration_cost"],
            "tier_counts": quick["recovery"]["tier_counts"],
            "applied_sq": quick["recovery"]["applied_sq"],
            "maint_seconds_per_iter": quick["maint_seconds_per_iter"],
            "cpu_maint_seconds_per_iter": quick_cpu["maint_seconds_per_iter"],
            "fabric_stats": quick["fabric_stats"]},
        "per_call": {name: {k: r[k] for k in (
            "leaf_ms", "leaf_plain_ms", "leaf_bound_ms", "host_us",
            "plain_host_us")} for name, r in kernels.items()
            if "leaf_ms" in r},
        "scatter_save_moved_bytes": kernels["scatter_save"]["moved_bytes"],
        "arena_scatter_moved_bytes": kernels["arena_scatter"]["moved_bytes"],
        "arena_maintain_dest_tiles": kernels["arena_maintain"]["dest_tiles"]}))
    log(card)
    log(json.dumps({"kernels": record}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
