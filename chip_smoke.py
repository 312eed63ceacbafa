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
   masked_restore bit-exact. block_dist, scatter_save and masked_restore
   are checked per leaf and in the grouped form the main paths run (one
   call over all 338 leaves; block_dist bit-identical over two runs; two
   kernel launches a block_dist call and one a scatter_save or
   masked_restore call, counted by the profiler; masked_restore also
   against ``torch.where`` on the block views), and the grouped call is
   what their ``ms`` times (the per-leaf list's time, and block_dist's
   per-leaf plain list's, are kept beside it; for masked_restore also the
   host time of its outputs' allocation, one buffer against one
   ``empty_like`` a leaf). Whole-tree times from CUDA events (median of
   7, plain and kernel in turns), beside the least time the card could
   take (bytes over 3.35 TB/s; operations over 67 TFLOP/s f32, or, for
   gf256_mac's integer work, over the card's INT32 rate: its SMs x 64
   lanes x its maximum SM clock).
3. The arena kernels at full size: the same tree packed into the flat
   word arena (1,544,728,576 words) with ``FabricConfig()``'s parity
   striping. arena_maintain (parity bit-exact, scores within rtol 1e-4),
   arena_scatter (a seeded 1/8 of the blocks, bit-exact) and parity_xor
   (the whole-arena encode, bit-exact and equal to the sweep's parity),
   timed as in phase 2. Then masked_restore with this arena as its source
   (the PEER_REPLICA tier's restore of phase 7's loss): one grouped launch
   over the touched leaves, the arena read in place, bit-exact against its
   plain route and timed as in phase 2.
4. The fabric-less path: ``make_model("mlr")`` at its defaults on
   ``cuda``; ``run_clean``, ``run_with_failure`` with
   ``CheckpointPolicy.scar()`` and ``CheckpointPolicy.traditional()``, the
   Theorem 3.2 bound as the quickstart computes it, and the same SCAR run
   on the CPU to hold the card's losses and iteration cost against. Then
   every kernel against its plain version at the MLR leaves' own shapes,
   and the grouped block_dist, scatter_save and masked_restore over the
   whole MLR tree.
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
    phase, each multi-erasure run and each served model (phases 15 and
    16) and each served family (phases 19, 20 and 24-26), and read just
    after it. Each path's kernels must have launched in it: ssd_intra 96 times on
    the mamba2_serve path (48 layers, two prefills), sw_attention 56 times
    on the qwen2_serve path (28 layers, a prefill and a ring prefill),
    ssd_intra 76 and sw_attention 14 times on the zamba2_serve path (38
    layers and 7 applications of the shared block, two prefills),
    sw_attention 48 times on the whisper_serve path (24 decoder layers,
    two prefills), 8 times on the qwen3_moe_serve and internvl2_serve
    paths (4 layers, two prefills) and 4 on the llama4_serve path (one
    dense + MoE pair, two generates); block_dist, scatter_save and
    masked_restore on the mamba2, zamba2, whisper, qwen3-moe and internvl2
    serve paths (their recovery flows).
14. After the 1.54 B tree is freed, the serve kernels at the shapes the
    served prefills give them, against their plain versions
    (|got - want| <= 1e-4 |want| + 1e-4 max|want|; the same for bf16
    inputs, which both versions read exactly) and bit-identical run to run:
    ssd_intra at mamba2-370m's (B 8, nc 16, Q 128, H 32, P 64, N 128) and
    zamba2-1.2b's (B 8, nc 16, Q 128, H 64, P 64, N 64), sw_attention at
    qwen2-1.5b's causal (B 4 x 2 kv heads, G 6, S 2048, W = S) and ring (B
    1, S 8192, W 4096) cases, zamba2-1.2b's (B 8 x 32 heads, G 1, S 2048,
    Dh 64, W = S), whisper-medium's decoder (B 8 x 16 heads, G 1, S 384,
    Dh 64, W = S), qwen3-moe-235b-a22b's (B 4 x 4 kv heads, G 16, S 2048,
    W = S), llama4-maverick-400b-a17b's (B 4 x 8, G 5, S 2048) and
    internvl2-76b's (B 4 x 8, G 8, S 3072: 1,024 patches and 2,048
    tokens) and command-r-plus-104b's 32k prefill (B 1 x 8, G 12, S
    32768; its plain version by blocks of query rows, timed once, the
    kernel and SDPA (``is_causal``) three times), bf16. Timed as in phase 2
    (and back to back, ten calls on one stream) beside the bound
    (ssd_intra: its bytes over 3.35 TB/s, or its products as three TF32
    products each over 495 TFLOP/s, with the f32-FMA figure of earlier runs
    beside it; sw_attention: its band's FLOPs over the bf16 tensor-core
    rate, 989 TFLOP/s) and, for sw_attention, beside
    ``F.scaled_dot_product_attention`` with the band mask (timed only).
    Each kernel's tensor-core FLOPs are printed, with the split's extra
    products, and the HGMMA and HMMA instructions that ``cuobjdump -sass``
    finds in the built library's functions: the run fails unless
    sw_attention's bf16 instances hold HGMMA and ssd_intra HMMA.
15. mamba2-370m served at full width (48 layers, d 1024, bf16, random
    weights from a seed): ``Server.generate`` on an (8, 2048) prompt with
    32 new tokens; then ``examples/serve_with_recovery.py``'s flow
    (``FTController`` with ``CheckpointPolicy.scar(1.0, 1)``, a 30% loss,
    partial restore) and the same tokens generated again, which must be
    identical. The flow must apply no perturbation; its checkpoint and
    restore are held bit for bit against the params and the plain
    masked_restore, and block_dist's per-block norms of the served tree
    against its plain version (rtol 1e-4). Then every ssd_intra call of a served prefill is held
    against the plain version on the same inputs, and, with the weights
    cast to f32, the prefill's last logits against the same prefill with
    the plain version (relative L2 <= 5e-3; the bf16 distance is reported:
    the random-weight models amplify each layer's 1-ulp bf16 flips).
    Prefill and decode tokens/s, a profile of one prefill (the card's busy
    seconds and its eight largest kernels) and peak device memory are
    reported; phase 16 reports the same.
16. qwen2-1.5b served at full width (28 layers, d 1536, GQA 12/2, bf16,
    untied head, as the config has it): ``Server.generate`` on (4, 2048)
    with 16 new tokens, a ring prefill of 8,192 tokens
    (``cache_spec(use_window=True)``: the band kernel with W = 4096) and
    one decode step; the kernel route held against the plain route as in
    phase 15; in f32, the ring decode step's logits against a ring prefill
    of the 8,193 tokens (relative L2 <= 5e-3).

17. The LM trainer (``training.TrainLoop``), after the serve phases free
    their models: (a) qwen2-1.5b at full width and depth (28 layers, bf16,
    the untied head, 1,777,088,000 values held as per-layer leaves),
    adamw(3e-4), ``CheckpointPolicy.scar(0.125, 2)``, ``FabricConfig()``,
    arena-resident, batch 4 x 2048 from ``ShardedLMDataset(seed=0)``, 8
    steps with hosts 0 and 2 lost together at step 5 (one host's loss
    recovers every block from PEER_REPLICA: the replicas are
    rack-anti-affine). Checked: finite losses, step 1's within 1.0 of ln
    V, every maintain resident (no pack), the tier counts summing to the
    lost blocks, ‖δ′‖² 0 for PEER_REPLICA and PARITY, and arena_maintain,
    arena_scatter, masked_restore, block_dist and parity_xor launched on
    this path (``launches["train"]``). Reported: step seconds and tokens/s
    over the clean steps, the clean-step overhead's p50/p95 and its
    sweep/save/fence split, the recovery's seconds and tier counts, peak
    device memory, the card's busy share of one clean step and the
    host's cProfile of another. (b) The
    same model with 4 layers, arena-resident and on the PyTree path in
    turn under deterministic algorithms, 4 steps (``scar(0.125, 2)``
    saves 1/8 of the blocks every step: its partial interval is 2 x
    0.125, rounded up to 1): losses, checkpoint arena, ``saved_iter`` and
    final parameters bit-equal. (c) Reduced qwen2-1.5b and mamba2-370m (f32, 2 layers) on
    the card and on the CPU from the same weights and batches, 6 steps
    and one ``inject_failure(0.5)``: losses within rtol 1e-4,
    ``saved_iter`` and tier counts equal. (d) mamba2-370m at full width
    with 4 of its 48 layers, arena-resident, 3 steps: finite losses, peak
    memory.
18. The disk store and async maintenance, in a fresh directory under
    ``build/`` (its free space checked against 20 GB first; removed at the
    end, also when a check fails): (a) phase 17(a)'s model with 4 of its
    28 layers, and its batches, with ``FabricConfig(async_maintain=True)``,
    a ``ShardedCheckpointStore``, ``scar(0.125, 32)`` (a 1/8 save every 4
    steps), 8 steps, hosts 0 and 2 lost at step 5, held against the same
    run synchronous without a store (deterministic algorithms on in both):
    losses, the checkpoint arena and the tier counts equal; every sweep
    launched on the fabric's side stream; the store read back onto the
    card equal to the checkpoint arena.
    Reported: step seconds, the clean-step overhead and its split, the
    fences, ``overlap_efficiency``, each save's seconds split into the
    device-to-host copies, the background append and the parity mirror,
    ``bytes_mirrored``, the disk bytes, the recovery, device memory after
    each step. (b) The same model with 4 layers, ``FabricConfig(
    replicate=False, parity=False)`` and a store, the PyTree path, 4 steps
    and the two-host loss: DISK blocks > 0, restored in one masked_restore
    launch from one read of the masked blocks, equal to the running
    checkpoint; the store read through the CPU reader equals the card's
    checkpoint. (c) The ported ``examples/train_lm_with_failures.py`` at
    ``--tiny``, arena-resident and ``--pytree``: bit-equal losses.

19. zamba2-1.2b served at full width (38 Mamba2 layers, d 2048, the
    shared attention block applied after every 6, 7 times; bf16, random
    weights from a seed): ``Server.generate`` on (8, 2048) with 32 new
    tokens, the recovery flow and the route hold as in phase 15 (ssd_intra
    and sw_attention call by call in bf16, the last logits in f32).
20. whisper-medium served at full width (24 encoder and 24 decoder
    layers, d 1024, vocab 51,865, bf16, the config's untied head): 1,500
    frames and a 384-token prompt a sequence, batch 8, 32 new tokens, the
    recovery flow and the route hold; sw_attention in the decoder's
    self-attention prefill (the encoder's and the cross-attention are the
    plain chunked attention, as in the reference).
21. zamba2-1.2b trained at full width, 7 of its 38 Mamba2 layers (two
    segments, the shared block twice, its gradient the sum of both uses;
    the depth cut to the script's time budget), d 2048, bf16, as
    per-layer leaves (the shared block one set of leaves), as phase 17(a)
    trains qwen2-1.5b: adamw(3e-4), ``scar(0.125, 2)``, ``FabricConfig()``,
    arena-resident, batch 4 x 2048 from ``ShardedLMDataset(seed=0)``, 8
    steps, hosts 0 and 2 lost at step 5. Phase 17(a)'s checks (step 1's
    loss within 1.0 of ln 32000) and reports, and ``check_train_kernels``
    on the run's own arena; ``launches["zamba2_train"]``.
22. whisper-medium trained at full width, its 24 encoder layers and 12
    of its 24 decoder layers (the depth cut to the script's time budget),
    d 1024, the untied head, bf16, 761,667,584 values, as phase 21, on
    batches of 4 sequences of 1,500 frames and 448 tokens (the published
    decoder context); step 1's loss within 1.0 of ln 51865;
    ``launches["whisper_train"]``.
23. The six ported examples (``repro_torch.examples``) on the card, each
    once at its default size: quickstart, priority_vs_random_checkpoints,
    adaptive_checkpoint_policy, correlated_failures, serve_with_recovery
    for yi-9b, mamba2-370m, zamba2-1.2b, whisper-medium, qwen3-moe-235b-a22b,
    llama4-maverick-400b-a17b and internvl2-76b (reduced), and
    train_lm_with_failures at ``--tiny`` (8 steps, ``--fail-prob 0.3``)
    for zamba2-1.2b, whisper-medium, qwen3-moe-235b-a22b and
    internvl2-76b; each held against the same call on
    the CPU (the LM examples from the same numpy weights and prompts; in
    the full run the CPU's calls run in a host process of their own,
    one torch thread, beside phases 10-22): tier
    counts, fallbacks, lost blocks, tokens and the advisor's choices equal,
    iteration costs within ±1, losses and the fitted contraction within
    rtol 1e-4; every kernel but fused_maintain launched on this path
    (``launches["examples"]``).
24. qwen3-moe-235b-a22b at full width (d 4096, GQA 64/4, 128 experts top-8
    of d_ff 1536, the untied head, bf16, random weights from a seed) with 4
    of its 94 layers (11.20 G values, 22.4 GB): ``Server.generate`` on (4,
    2048) with 16 new tokens, the recovery flow and the route hold as in
    phase 15 (the save and restore held leaf by leaf: a fourth 22.4 GB tree
    would not fit), the prefill's logits bit-identical over two runs; the
    f32 route hold on 2 of the 4 layers (the f32 tree of all 4 is 44.8 GB
    beside the bf16 one).
25. llama4-maverick-400b-a17b at full width (d 5120, GQA 40/8, one dense
    layer of d_ff 16384 and one MoE layer of 128 experts top-1 of d_ff 8192
    with the shared expert: one interleaved pair, 18.68 G values, 37.4 GB):
    two generates on (4, 2048) + 16 tokens, identical; the prefill's logits
    bit-identical over two runs; every sw_attention call of a bf16 prefill
    held against its plain version, the bf16 distance to the plain route
    reported. Its recovery flow and f32 route hold run on its reduced
    config in phase 23: two more trees would not fit.
26. internvl2-76b at full width (d 8192, GQA 64/8, d_ff 28672, the
    projector from 3200) with 4 of its 80 layers (5.55 G values): 1,024
    patches and 2,048 tokens a prompt (3,072 positions, inside its 4,096
    window), batch 4, 16 new tokens, as phase 24 (the f32 route on every
    layer).
27. internvl2-76b trained at full width (d 8192, GQA 64/8, d_ff 28672, the
    projector from 3200, the untied head, bf16) with 1 of its 80 layers
    (2,983,223,296 values as per-layer leaves, ``wo`` one (8192, 8192)
    leaf), as phase 21: batches of 4 x (1,024 stub patches + 2,048
    tokens) run as the config's 4 microbatches, 6 steps (cut from 8 for
    the script's time), hosts 0 and 2 lost at step 5; phase 17(a)'s
    checks (step 1's loss within 1.0 of ln 128256, the live tiers at zero
    perturbation) with PEER_REPLICA and PARITY both used, its reports,
    positions/s beside tokens/s, and ``check_train_kernels`` on the run's
    own arena; ``launches["internvl2_train"]``.
28. (a) qwen3-moe-235b-a22b's MoE layer at full width (d 4096, 128 experts
    top-8 of d_ff 1536, bf16, the f32 router) on (4, 2048) tokens, forward
    and backward on the trainer's per-expert leaves, against the stacked
    route's ``torch.bmm`` on the same inputs: finite gradients, the
    router's and every expert's within relative L2 1e-3 in f32, the aux
    losses equal; seconds and peak reported. (The whole model does not
    train on one card: ROADMAP's MoE training memory item.) (b) The
    three families' reduced configs trained on the card and on the CPU as
    phase 17(c) (losses within rtol 1e-4, tier counts equal, PARITY used)
    and, on the card, arena = PyTree bit for bit under deterministic
    algorithms, also llama4's in bf16 with its bf16 moments and 2
    microbatches; ``launches["moe_train"]``.

29. The perf variants, on command-r-plus-104b at full width (d 12288,
    GQA 96/8, d_ff 33792, vocab 256,000, the untied head, bf16, random
    weights from a seed) with 4 of its 64 layers (12.58 G values, 25.17
    GB), on a (1, 32768) prompt. (a) A prefill with the variants off and
    one with ``triangle_prefill`` and ``kv_quant`` on (peak), the same
    bits of logits; for each arm a warm prefill and ``Server.generate``
    of 16 tokens, both unprofiled (prefill tokens/s, decode tokens/s from
    their difference), and one prefill under the profiler (busy share);
    both prefills again with every sw_attention call held against its
    plain version (by blocks of query rows: one row's scores are 51.5
    GB), each call's worst element logged; the port's plain
    ``flash_attention_triangle`` on the card on layer 0's q, k, v against
    the kernel. (b) The int8 cache's dtype and bytes (half the bf16
    cache's plus the scales); the first decode step on each cache: the
    next-token probabilities within 0.05 (the reference's bound), the
    logits within a relative L2 of ``LOGITS_L2_TOL``, which a decode with
    the scales left out exceeds, and layer 0's new slot in the int8 cache
    ``quantize_kv`` of the bf16 cache's, bit for bit (a token not written
    is reported too); in f32 on layer 0's int8 cache,
    ``flash_attention_kvq`` against ``flash_attention`` over the
    dequantized cache. (c) 8 decode steps over a 32,832-slot cache filled
    at positions 0-32767 from seeded bf16 draws (the int8 arm:
    ``quantize_kv`` of the same draws), batch 8, each arm alone beside the
    model: seconds a step, busy share, cache bytes, peak (the int8 peak
    below the bf16 one), and (b)'s checks over every step. (d) yi-9b,
    granite-8b, command-r-plus-104b, qwen3-moe-235b-a22b,
    llama4-maverick-400b-a17b and internvl2-76b reduced, f32, both flags,
    card against CPU: prefill and decode logits within rtol 1e-4, atol
    1e-4, ``Server.generate``'s tokens equal. ``launches["perf_variants"]``
    counts sw_attention over (a)'s eight 32k prefills (the two generates'
    included): once a layer in each.
30. The sharded arena and the elastic mesh: qwen2-1.5b at full width (f32,
    2 of its 28 layers, untied head) trained on a (2, 2) mesh of 4
    ``torch.distributed`` ranks spawned on the one card (gloo: NCCL
    refuses two ranks on one device; every collective staged through
    page-locked host memory, in pieces, its bytes and seconds counted),
    ``FabricConfig(n_devices=4, devices_per_host=2, elastic=True)``,
    ``scar(0.125, 2)``, adamw(3e-4), batch 4 x 2048 (one sequence a rank),
    6 steps: host 1 lost at step 3 (4 -> 2 shards), healed at step 5 (2 ->
    4). The initial weights are drawn once here and handed to every rank
    as numpy; the same weights, batches and schedule run first on one rank
    in this process. Held: the arena and PyTree loops on the mesh
    bit-equal over their first 2 steps (losses, every rank's checkpoint
    and parameter spans); after the run, the 4-rank sweep's replica and
    parity bit-equal to a 1-rank sweep of the gathered arena, its scores
    within rtol 1e-4; the ranks' losses equal and within rtol 1e-4 of the
    one-rank run's; shards 4, 2, 4, two resizes, no live pack;
    arena_maintain, arena_scatter and parity_xor launched on every rank.
    Printed with the card's name and power limit: each rank's peak device
    and host memory, step seconds (one rank against the mesh), the
    resizes', recovery's and heal's seconds, each collective's calls,
    bytes, seconds and staged bytes. ``python3 chip_smoke.py --mesh`` runs
    phases 1 and 30 alone (``{"mesh_only": true, ...}``). Since the
    tensor- and expert-parallel forward, phase 30's ranks split the heads,
    d_ff and the vocab over the mesh's model axis.
31. **The tensor- and expert-parallel forward** (:func:`phase_moe_mesh`):
    qwen3-moe-235b-a22b at full width with 1 of its 94 layers on the same
    (2, 2) mesh, each rank placing only its model slices, one step and
    the gradient's mean over the data line held against one rank running
    the data shards as 2 microbatches (the loss, each gradient slice
    against an f32 yardstick, the MoE block's kept pairs and output); then
    reduced qwen3-moe and llama4-maverick trained on the mesh through a
    host loss that shrinks it to (2, 1) and a heal, held as phase 30's.
    ``python3 chip_smoke.py --moe-mesh`` runs phases 1 and 31 alone
    (``{"moe_mesh_only": true, ...}``).
32. **Tensor parallelism for the ssm, hybrid and encoder-decoder
    families** (:func:`phase_ssm_mesh`): zamba2-1.2b's first segment and
    whisper-medium at full width on the same mesh, one step held as 31's;
    the three reduced trainers through the shrink and the heal.
    ``python3 chip_smoke.py --ssm-mesh`` runs phases 1 and 32 alone
    (``{"ssm_mesh_only": true, ...}``).
33. **The Server on a mesh** (:func:`phase_serve_mesh`): 4 ranks on a
    (1, 4) mesh serve command-r-plus-104b at full width (2 of its 64
    layers; batch 2, a 4,608-token prompt, 16 greedy tokens, a bf16 arm
    and an int8 ring-cache arm) and zamba2-1.2b at full width (7 of its
    38 layers: two segments, a KV cache for each use of the shared block)
    (1,024 tokens), each rank placing only its model slices; held against
    one rank's bf16 and f32 routes in this process (the tokens the same on
    every rank, the last prefill logits within 1.5 times one device's bf16
    floor), the serve-with-recovery flow on every rank (the same tokens
    after it), every sw_attention and ssd_intra call and the recovery's
    kernels against their plain versions; then every family reduced, f32,
    on a (2, 2) mesh, the card against the CPU. ``python3 chip_smoke.py
    --serve-mesh`` runs phases 1 and 33 alone (``{"serve_mesh_only":
    true, ...}``). The held prefill logits and kernel calls are the
    generate's own prefill's (:func:`_recording_prefill`).
34. **The launch analytics** (:func:`phase_launch`): (a) the four §Perf
    pairs at full width on one rank of the dry (16, 16) production mesh
    and the one-card roofline of phase 29's command-r-plus-104b prefill and
    decode beside phase 29's measured seconds, computed on meta tensors
    in host processes (:data:`LATE_JOBS`) and joined before phase 30; (b)
    rank 0 of that mesh's pair A and
    C baselines run on the card at depths 1 and 2 through the counting
    stand-in (argument bytes equal to the meta run's, its temp bytes
    within 10% of the card's peak over the step's baseline, the seconds
    extrapolated to 64 layers beside the roofline terms; sw_attention at
    G 3, 4 and 6 against plain); (c) qwen2-1.5b
    at full width served on the (1, 4) mesh, 3 query heads over the one
    kv head that two ranks share, a bf16 and an int8 arm (tokens equal
    over the ranks and to one rank's, logits within 1.5 times one
    device's bf16 floor, sw_attention against plain), and one TP train
    step at 4 layers held as phase 31(a). ``python3 chip_smoke.py
    --launch`` runs phases 1 and 34 alone (``{"launch_only": true,
    ...}``).
35. **Query heads that do not split over the model axis**
    (:func:`phase_uneven_heads`): each model position computes whole
    query heads, ``[ceil(r Hq / tp), ceil((r+1) Hq / tp))``, and holds the
    kv heads they read. (a) sw_attention at G 3, 2 and 1 against plain,
    timed; model positions 0 and 1 of the dry (16, 16) mesh run
    llama4-maverick-400b-a17b's first dense + MoE pair at full width (3
    and 2 of the 40 query heads over the kv head they share), the
    prefill_32k and decode_32k steps through the counting stand-in
    (argument bytes equal to the meta run's, computed on the host before
    the mesh phases; temp bytes within 10% of the card's peak; every
    sw_attention call
    against plain); rank 3 of qwen2-1.5b's (16, 16) mesh, which holds no
    query head, launches no sw_attention. (b) qwen2-1.5b at full width
    and depth served on a (1, 8) mesh of 8 gloo ranks (2, 1, 2, 1, ...
    query heads), a bf16 and an int8 arm, the serve-with-recovery flow on
    every rank, and one TP train step at 4 layers, held as 34(c) on its
    yardstick. ``python3 chip_smoke.py --uneven-heads`` runs phases 1 and
    35 alone (``{"uneven_heads_only": true, ...}``).
36. **The mesh train step on the rank's model slices**
    (:func:`phase_slice_train`): rank 0 of the dry (16, 16) mesh trains
    granite-8b at full width and depth (36 layers, f32 as the dry run,
    ``train_4k``: its data shard of 16 sequences of 4,096 tokens) through
    ``dryrun.build_rank_step`` and the counting stand-in, gathering only
    its model slices (a sixteenth of the model), each layer's while it
    runs. Held: the argument bytes
    equal to the same step's full-depth meta run's (computed in a host
    process before the mesh phases), the card's peak over the step's baseline within 10%
    of its temp bytes and under 80 GB, the gathers' and reduces' counts
    and bytes what the slice plan's groups add up to. Printed: the step's
    seconds (one step, timed with no untimed step before it). The
    stand-in's values are unset, so no value
    is held. ``python3 chip_smoke.py --slice-train`` runs phases 1 and 36
    alone (``{"slice_train_only": true, ...}``).
37. **The mesh train step gathers each layer's slices as it runs**
    (:func:`phase_layer_train`): rank 0 of the dry (16, 16) mesh trains
    llama4-maverick-400b-a17b at full width and depth (48 layers, 24
    dense + MoE pairs, f32, ``train_4k`` at microbatch 4) as phase 36
    does: each layer's slices gathered in its forward and again in its
    recompute, its gradient sent as the backward leaves it, so the rank
    holds the outer group (embedding, head, norms), one layer and the
    remat checkpoints. Held as phase 36 (the peak under 80 GB less the
    argument bytes), and no layer group above a tenth of the rank's
    slices. Printed: one step's seconds, timed with no untimed step before
    it. ``python3 chip_smoke.py --layer-train`` runs phases 1 and 37 alone
    (``{"layer_train_only": true, ...}``).

The line before the last is the kernels' JSON record (each kernel's
launches on its own path, ``train_launches`` on phase 17's,
``store_launches`` on phase 18's (a) and (b) together,
``zamba2_launches`` and ``whisper_launches`` on phases 19 and 20,
``zamba2_train_launches``, ``whisper_train_launches`` and
``examples_launches`` on phases 21, 22 and 23, ``qwen3_moe_launches``,
``llama4_launches`` and ``internvl2_launches`` on phases 24-26,
``internvl2_train_launches`` and ``moe_train_launches`` on phases 27 and
28(b), ``perf_variants_launches`` on phase 29(a)-(b), ``mesh_launches``
on phase 30's run, ``moe_mesh_launches`` on phase 31(b)'s two elastic
runs, ``ssm_mesh_launches`` on phase 32(b)'s three and
``serve_mesh_launches`` on phase 33(a)-(b)'s serve paths, one count a
rank, ``launch_launches`` on phase 34(b)'s timed runs and (c)'s serve
windows on rank 0, ``uneven_heads_launches`` on phase 35(a)'s timed runs
and (b)'s windows on every rank); the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device it exits non-zero
and prints no result.

``python3 chip_smoke.py --erasure`` runs phase 1, phase 3's parity_xor
encode and phase 9 alone and prints the erasure kernels' SASS instruction
mix; its last line is ``{"erasure_only": true, "device": {...}}``, not the
full run's. ``python3 chip_smoke.py --train`` runs phase 1 and phase 17
alone; its last line is ``{"train_only": true, "device": {...}}``.
``python3 chip_smoke.py --store`` runs phase 1 and phase 18 alone; its last
line is ``{"store_only": true, "device": {...}}``.
``python3 chip_smoke.py --families`` runs phases 1, 14, 19 and 20 alone;
its last line is ``{"families_only": true, "device": {...}}``.
``python3 chip_smoke.py --train-families`` runs phases 1, 21 and 22 alone
(``{"train_families_only": true, ...}``); ``python3 chip_smoke.py
--examples`` runs phases 1 and 23 alone (``{"examples_only": true,
...}``); ``python3 chip_smoke.py --moe-vlm`` runs phases 1, 14 and 24-26
alone (``{"moe_vlm_only": true, ...}``); ``python3 chip_smoke.py
--train-moe-vlm`` runs phases 1, 27 and 28 alone
(``{"train_moe_vlm_only": true, ...}``); ``python3 chip_smoke.py
--perf-variants`` runs phases 1, 14 and 29 alone
(``{"perf_variants_only": true, ...}``).
"""
from __future__ import annotations

import contextlib
import gc
import itertools
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# phase 17(b) runs cuBLAS under deterministic algorithms, which needs a
# fixed workspace configured before CUDA starts
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
F32_FLOPS_PER_S = 67e12          # H100 SXM, f32 outside the tensor cores
BF16_TC_FLOPS_PER_S = 989e12     # H100 SXM, dense bf16 tensor cores
TF32_TC_FLOPS_PER_S = 495e12     # H100 SXM, dense TF32 tensor cores
BLOCK_ROWS = 128
TIMING_RUNS = 7
# gf256_mac's plain passes take 1.9-3.4 s each: timed 3 times, not 7
PLAIN_GF256_RUNS = {"plain": 3}
SEED = 0


START = time.perf_counter()


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
    QKV biases, tied embedding, as the published model has it. The
    registered config (``configs/qwen2_1_5b.py``) leaves ``tie_embeddings``
    False; the model served in phase 16 follows the config and carries a
    separate 151,936 x 1,536 head."""
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


def in_turns(fns: dict, before=None, runs: Optional[dict] = None) -> dict:
    """Median ms of each whole-tree pass, the passes taken in turns.
    ``before()``, when given, runs ahead of every pass, outside its
    timing. ``runs`` gives a pass fewer timed runs than ``TIMING_RUNS``
    (gf256_mac's plain passes take seconds each)."""
    import torch
    for fn in fns.values():            # warm-up (allocator, first launch)
        if before is not None:
            before()
        fn()
    torch.cuda.synchronize()
    times = {name: [] for name in fns}
    runs = runs or {}
    for i in range(TIMING_RUNS):
        for name, fn in fns.items():
            if i >= runs.get(name, TIMING_RUNS):
                continue
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
    """Card milliseconds per call, back to back on one stream. Each call's
    result is dropped before the next call, as a caller that keeps one
    output at a time would (ten whole-tree outputs would not fit)."""
    def calls_in_a_row():
        for _ in range(calls):
            fn()
    return statistics.median(cuda_ms(calls_in_a_row, runs=3)) / calls


def device_share(fn) -> dict:
    """Run ``fn`` once under torch.profiler: its wall seconds (ending in a
    synchronize), the seconds the card spent in kernels and copies (its
    own events, not the operators that launched them), and the eight names
    that took most of them. ``device_s`` is 0 where the
    profiler records no device activity. Only the device's activity is
    recorded (recording every operator on the host slows a host-bound step
    by half), and the profiler's raw events are summed directly: building
    its ``key_averages()`` tree takes a minute for a training step of a few
    hundred thousand events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # the card's own events only (kernels, copies, sets): an operator's
    # row repeats the device time of the kernels it launched
    per_name: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and not e.is_user_annotation():
            per_name[e.name()] = per_name.get(e.name(), 0) + e.duration_ns()
    device_s = sum(per_name.values()) / 1e9
    top = sorted(per_name.items(), key=lambda r: -r[1])[:8]
    return {"wall_s": wall, "device_s": device_s,
            "busy_share": device_s / wall if wall > 0 else None,
            "top_device_ms": [[k[:60], ns / 1e6] for k, ns in top]}


def timed_allocs(fn):
    """Run ``fn`` once between two synchronizes: its result, its wall
    seconds, and the caching allocator's ``cudaMalloc`` calls and
    free-and-retry events during it (``torch.cuda.memory_stats``)."""
    import torch
    keys = ("num_device_alloc", "num_alloc_retries")
    before = torch.cuda.memory_stats()
    out, seconds = _timed(fn)
    after = torch.cuda.memory_stats()
    return out, seconds, {k: after.get(k, 0) - before.get(k, 0)
                          for k in keys}


def kernel_launches(fn, name: str) -> tuple[int, float]:
    """Run ``fn`` once under torch.profiler: how many kernels whose name
    holds ``name`` the card ran, and their device milliseconds."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.count, e.self_device_time_total) for e in prof.key_averages()
            if name in e.key and e.self_device_time_total > 0]
    return sum(n for n, _ in rows), sum(us for _, us in rows) / 1e3


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
    import numpy as np
    import torch
    from repro_torch.core.blocks import leaf_block_view, partition_pytree
    from repro_torch.kernels import _build
    from repro_torch.kernels.block_dist.kernel import block_dist_cuda
    from repro_torch.kernels.block_dist.ops import tree_block_dist
    from repro_torch.kernels.block_dist.ref import (block_dist_ref,
                                                    block_dist_tree_ref)
    from repro_torch.kernels.fused_maintain.kernel import (
        scatter_save_cuda, scatter_save_tree_cuda)
    from repro_torch.kernels.fused_maintain.ops import tree_scatter_save
    from repro_torch.kernels.fused_maintain.ref import scatter_save_ref
    from repro_torch.kernels.leaf_table import (block_dist_table,
                                                 restore_table, save_pairs)
    from repro_torch.kernels.masked_restore.kernel import (
        masked_restore_cuda, masked_restore_tree_cuda)
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

    # block_dist: rtol 1e-4 (f32 sums in another order over <= 1.1 M terms),
    # per leaf and in the grouped form over the whole tree, which the main
    # path runs: one call, two launches, the same bits on every run
    def rel_err(got, want):
        return float(((got - want).abs() / want.abs().clamp_min(1e-30)).max())

    err = 0.0
    for va, vb in views:
        got, want = block_dist_cuda(va, vb), block_dist_ref(va, vb)
        check(rel_err(got, want) <= 1e-4,
              f"block_dist off by rtol {rel_err(got, want)}")
        check(torch.equal(got, block_dist_cuda(va, vb)),
              "block_dist differs between two runs")
        err = max(err, float((got - want).abs().max()))
    table = block_dist_table(part)
    tree_call = lambda: tree_block_dist(a_leaves, b_leaves, part)
    got, want = tree_call(), block_dist_tree_ref(a_leaves, b_leaves, part)
    check(rel_err(got, want) <= 1e-4,
          f"grouped block_dist off by rtol {rel_err(got, want)}")
    check(torch.equal(got, tree_call()),
          "grouped block_dist differs between two runs")
    tree_err = float((got - want).abs().max())
    grid, card = kernel_launches(tree_call, "block_dist")
    check(grid == 2, f"a grouped block_dist call ran {grid} kernels, not 2")
    t = in_turns({
        "plain": lambda: block_dist_tree_ref(a_leaves, b_leaves, part),
        "per_leaf_plain": lambda: [block_dist_ref(va, vb) for va, vb in views],
        "per_leaf": lambda: [block_dist_cuda(va, vb) for va, vb in views],
        "kernel": tree_call})
    b, by = bound_ms(2 * 4 * n_values + 4 * part.total_blocks, 3 * n_values)
    results["block_dist"] = dict(
        max_abs_err=max(err, tree_err), ms=t["kernel"], plain_ms=t["plain"],
        bound_ms=b, bound_by=by, library_ms=None, per_leaf_ms=t["per_leaf"],
        per_leaf_plain_ms=t["per_leaf_plain"], b2b_ms=device_ms(tree_call), card_ms=card, grid_launches=grid,
        work_items=table.n_items)
    (ba, bb), (sa, sb) = views[big], views[small]
    # host time of the whole-tree call: the same leaves (the pointer column
    # stays on the card) and other leaves every call (it is uploaded again)
    flip = itertools.cycle([(b_leaves, a_leaves), (a_leaves, b_leaves)])
    results["block_dist"].update(
        leaf_ms=device_ms(lambda: block_dist_cuda(ba, bb)),
        leaf_plain_ms=device_ms(lambda: block_dist_ref(ba, bb)),
        leaf_bound_ms=bound_ms(8 * ba.numel() + 4 * ba.shape[0])[0],
        host_us=host_us(tree_call, calls=20),
        host_us_new_leaves=host_us(lambda: tree_block_dist(
            *next(flip), part), calls=20),
        plain_host_us=host_us(lambda: block_dist_tree_ref(
            a_leaves, b_leaves, part), calls=5),
        leaf_host_us=host_us(lambda: block_dist_cuda(sa, sb)))

    # masked_restore on the raw (R, W) rows, bit-exact: per leaf, and in
    # the grouped form the main paths run (one launch over every leaf,
    # the mask read at each leaf's global offset), against the per-leaf
    # plain list and torch.where on the block views. Every leaf of this
    # tree fills its blocks, so its block view is a view, and torch.where
    # on it is the one-call yardstick.
    for (dv, sv), m in zip(rows2d, masks):
        check(torch.equal(masked_restore_cuda(dv, sv, m, BLOCK_ROWS),
                          masked_restore_ref(dv, sv, m, BLOCK_ROWS)),
              "masked_restore differs from its plain version")
    check(all(va.data_ptr() == x.data_ptr() for (va, _), x
              in zip(views, a_leaves)), "a block view is a padded copy")
    gmask = torch.cat(masks)
    check(gmask.numel() == part.total_blocks, "the leaves' masks do not "
          "tile the global mask")
    tree_restore = lambda: masked_restore_tree_cuda(a_leaves, b_leaves,
                                                    gmask, part)
    n0 = _build.LAUNCHES["masked_restore"]
    got = tree_restore()
    check(_build.LAUNCHES["masked_restore"] == n0 + 1,
          "the grouped masked_restore call did not make one launch")
    for g, (dv, sv), (va, vb), m in zip(got, rows2d, views, masks):
        check(torch.equal(g.reshape(dv.shape),
                          masked_restore_ref(dv, sv, m, BLOCK_ROWS))
              and torch.equal(g.reshape(va.shape),
                              torch.where(m[:, None], vb, va)),
              "grouped masked_restore differs from its plain version")
    del got
    grid, card = kernel_launches(tree_restore, "masked_restore")
    check(grid == 1, f"a grouped masked_restore call ran {grid} kernels, "
          f"not 1")
    t = in_turns({
        "plain": lambda: [masked_restore_ref(dv, sv, m, BLOCK_ROWS)
                          for (dv, sv), m in zip(rows2d, masks)],
        "per_leaf": lambda: [masked_restore_cuda(dv, sv, m, BLOCK_ROWS)
                             for (dv, sv), m in zip(rows2d, masks)],
        "library": lambda: [torch.where(m[:, None], sv, dv)
                            for (dv, sv), m in zip(views, masks)],
        "kernel": tree_restore})
    b, by = bound_ms(2 * 4 * n_values + part.total_blocks)
    table = restore_table(part, tuple(x.dtype for x in a_leaves))
    results["masked_restore"] = dict(
        max_abs_err=0.0, ms=t["kernel"], plain_ms=t["plain"], bound_ms=b,
        bound_by=by, library_ms=t["library"], per_leaf_ms=t["per_leaf"],
        b2b_ms=device_ms(tree_restore), card_ms=card, grid_launches=grid,
        work_items=table.n_items)
    (ra, rb), (rsa, rsb) = rows2d[big], rows2d[small]
    bm, sm = masks[big], masks[small]
    # host time of the whole-tree call (the same leaves, so the pointer
    # column is uploaded only when the output lands elsewhere; and other
    # leaves every call), and of its outputs' allocation alone: one buffer
    # with a typed view a leaf (the route kept) against one empty_like a
    # leaf, each with the leaves' addresses
    flip = itertools.cycle([(b_leaves, a_leaves), (a_leaves, b_leaves)])

    def one_buffer():
        raw = torch.empty((table.out_bytes,), dtype=torch.uint8,
                          device=device)
        typed, base = raw.view(torch.float32), raw.data_ptr()
        return [(typed.as_strided(shape, stride, off // 4), base + off)
                for shape, stride, off in zip(table.shapes, table.strides,
                                              table.out_off.tolist())]

    results["masked_restore"].update(
        leaf_ms=device_ms(lambda: masked_restore_cuda(ra, rb, bm,
                                                      BLOCK_ROWS)),
        leaf_plain_ms=device_ms(lambda: masked_restore_ref(ra, rb, bm,
                                                           BLOCK_ROWS)),
        leaf_bound_ms=bound_ms(8 * ra.numel() + bm.numel())[0],
        host_us=host_us(tree_restore, calls=20),
        host_us_new_leaves=host_us(lambda: masked_restore_tree_cuda(
            *next(flip), gmask, part), calls=20),
        alloc_us_one_buffer=host_us(one_buffer, calls=20),
        alloc_us_empty_like=host_us(lambda: [
            (x, x.data_ptr()) for x in map(torch.empty_like, a_leaves)],
            calls=20),
        plain_host_us=host_us(lambda: [
            masked_restore_ref(dv, sv, m, BLOCK_ROWS)
            for (dv, sv), m in zip(rows2d, masks)], calls=5),
        leaf_host_us=host_us(lambda: masked_restore_cuda(rsa, rsb, sm,
                                                         BLOCK_ROWS)))

    # scatter_save: bit-exact on copies, per leaf and grouped (the main
    # path's form: one launch over the selected (leaf, block) pairs), then
    # timed in place into b (the same ids each run, so every run writes
    # the same bytes)
    for (src, dst), ids in zip(rows2d, sel):
        got = scatter_save_cuda(dst.clone(), src, ids, BLOCK_ROWS)
        want = scatter_save_ref(dst.clone(), src, ids, BLOCK_ROWS)
        check(torch.equal(got, want),
              "scatter_save differs from its plain version")
    idx = np.sort(np.concatenate([l.offset + s.cpu().numpy().astype(np.int64)
                                  for l, s in zip(part.leaves, sel)]))
    leaf_of, block_of = save_pairs(idx, part)
    copies = [y.clone() for y in b_leaves]
    scatter_save_tree_cuda(copies, a_leaves, leaf_of, block_of, part)
    for (src, dst), ids, c in zip(rows2d, sel, copies):
        want = scatter_save_ref(dst.clone(), src, ids, BLOCK_ROWS)
        check(torch.equal(c.reshape(want.shape), want),
              "grouped scatter_save differs from its plain version")
    del copies, want, got
    tree_save = lambda: scatter_save_tree_cuda(b_leaves, a_leaves, leaf_of,
                                               block_of, part)
    grid, card = kernel_launches(tree_save, "scatter_save")
    check(grid == 1, f"a grouped scatter_save call ran {grid} kernels, not 1")
    t = in_turns({
        "plain": lambda: [scatter_save_ref(dst, src, ids, BLOCK_ROWS)
                          for (src, dst), ids in zip(rows2d, sel)],
        "per_leaf": lambda: [scatter_save_cuda(dst, src, ids, BLOCK_ROWS)
                             for (src, dst), ids in zip(rows2d, sel)],
        "kernel": tree_save})
    b, by = bound_ms(2 * moved + 4 * sum(int(s.numel()) for s in sel))
    results["scatter_save"] = dict(max_abs_err=0.0, ms=t["kernel"],
                                   plain_ms=t["plain"], bound_ms=b,
                                   bound_by=by, library_ms=None,
                                   moved_bytes=moved,
                                   per_leaf_ms=t["per_leaf"],
                                   b2b_ms=device_ms(tree_save),
                                   card_ms=card, grid_launches=grid,
                                   pairs=int(leaf_of.size))
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
        host_us=host_us(lambda: tree_scatter_save(b_tree, a_tree, idx, part),
                        calls=20),
        plain_host_us=host_us(lambda: [
            scatter_save_ref(dst, src, ids, BLOCK_ROWS)
            for (src, dst), ids in zip(rows2d, sel)], calls=5),
        leaf_host_us=host_us(lambda: scatter_save_cuda(sdst, ssrc, sids,
                                                       BLOCK_ROWS)))
    for name, r in results.items():
        lib = r["library_ms"]
        grouped = (f"; per-leaf list {r['per_leaf_ms']:.3f} ms"
                   + (f" (plain {r['per_leaf_plain_ms']:.3f})"
                      if "per_leaf_plain_ms" in r else "")
                   + f", back to back "
                   f"{r['b2b_ms']:.3f} ms, the card's kernels "
                   f"{r['card_ms']:.3f} ms in {r['grid_launches']} launches"
                   if "per_leaf_ms" in r else "")
        log(f"{name}: kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, "
            f"bound {r['bound_ms']:.3f} ms ({r['bound_by']}), library "
            f"{'none' if lib is None else format(lib, '.3f') + ' ms'}, "
            f"max abs err {r['max_abs_err']:.3g}{grouped}; largest leaf "
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
    results["parity_xor"] = whole_arena_parity_xor(x, lay, codec, device,
                                                   sweep_parity=par_k)
    arena_restore_rec = arena_source_restore(b_tree, x, fab)
    for name, r in results.items():
        log(f"{name} (whole arena): kernel {r['ms']:.3f} ms, plain "
            f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms "
            f"({r['bound_by']}{rate_note(r)}), library none "
            f"({r['library_note']}), max abs err {r['max_abs_err']:.3g}")
    results["masked_restore_arena"] = arena_restore_rec
    return results


def arena_source_restore(dst_tree, arena, fab) -> dict:
    """The PEER_REPLICA tier's restore from an arena-form replica at full
    size: ``dst_tree``'s blocks homed on block 0's primary and replica
    devices (phase 7's loss) taken from ``arena``. One grouped
    masked_restore launch over the touched leaves, the arena read in
    place: bit-exact against its plain route (each touched leaf decoded,
    then ``masked_restore_ref``), then timed as in phase 2."""
    import numpy as np
    import torch
    from repro_torch.core.arena import arena_restore, arena_restore_ref
    from repro_torch.kernels import _build
    from repro_torch.utils.tree import tree_leaves

    lay = fab.arena_layout
    homes = np.unique([fab.view.homes[0], fab.replicas.replica_homes[0]])
    mask = np.isin(fab.view.homes, homes)
    restore = lambda: arena_restore(dst_tree, arena, mask, lay)
    plain = lambda: arena_restore_ref(dst_tree, arena, mask, lay)
    n0 = _build.LAUNCHES["masked_restore"]
    got = tree_leaves(restore())
    check(_build.LAUNCHES["masked_restore"] == n0 + 1,
          "the arena-source restore did not make one launch")
    want = tree_leaves(plain())
    check(all(torch.equal(g.reshape(-1).view(torch.int32),
                          w.reshape(-1).view(torch.int32))
              for g, w in zip(got, want)),
          "the grouped arena restore differs from its plain route")
    touched = [g for g, x in zip(got, tree_leaves(dst_tree)) if g is not x]
    n_bytes = sum(g.numel() * g.element_size() for g in touched)
    n_touched = len(touched)
    del got, want, touched
    grid, card = kernel_launches(restore, "masked_restore")
    check(grid == 1, f"a grouped arena restore ran {grid} kernels, not 1; "
          f"the profiler saw {json.dumps(device_share(restore))}")
    t = in_turns({"plain": plain, "kernel": restore})
    out = {"ms": t["kernel"], "plain_ms": t["plain"], "card_ms": card,
           "b2b_ms": device_ms(restore), "grid_launches": grid,
           "blocks": int(mask.sum()), "touched_leaves": n_touched,
           "touched_bytes": n_bytes,
           "bound_ms": bound_ms(2 * n_bytes + mask.size)[0],
           "host_us": host_us(restore, calls=20)}
    log(f"masked_restore from the arena (PEER_REPLICA, {out['blocks']} "
        f"blocks): {json.dumps(out)}")
    return out


def rate_note(r: dict) -> str:
    """The achieved rate and share of the bound of a launch that records
    its ``bytes``."""
    if "bytes" not in r:
        return ""
    return (f"; {r['bytes'] / r['ms'] / 1e6:.1f} GB/s achieved, "
            f"{r['bound_ms'] / r['ms']:.3f} of the bound")


def whole_arena_parity_xor(x, lay, codec, device,
                           sweep_parity=None) -> dict:
    """parity_xor's whole-arena encode of ``FabricConfig()``'s striping:
    bit-exact against the plain version (and equal to the sweep's parity
    where given), timed as in phase 2 beside a device-to-device copy of
    the arena, the card's streaming rate on the same bytes."""
    import torch
    from repro_torch.kernels.parity_xor.kernel import parity_xor_cuda
    from repro_torch.kernels.parity_xor.ops import encode_plan
    from repro_torch.kernels.parity_xor.ref import parity_xor_ref

    n_par = codec.n_groups * codec.layout.frame_elems
    t0 = time.perf_counter()
    plan = encode_plan(lay, codec.layout, codec.members)
    plan_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plan.pieces()
    pieces_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pt = plan.pieces_on(device)
    upload_s = time.perf_counter() - t0
    out_k = torch.empty((n_par,), dtype=torch.int32, device=device)
    parity_xor_cuda(out_k, x, None, pt)
    if sweep_parity is not None:
        check(torch.equal(out_k, sweep_parity), "parity_xor encode differs "
              "from the arena_maintain parity")
    plain_t = plan.on(device)
    out_p = parity_xor_ref(torch.empty_like(out_k), x, None, plain_t)
    check(torch.equal(out_k, out_p), "parity_xor differs")
    del out_p
    n_bytes = plan.read_bytes + 4 * n_par
    b, by = bound_ms(n_bytes)
    copy = torch.empty_like(x)
    tm = in_turns({"plain": lambda: parity_xor_ref(out_k, x, None, plain_t),
                   "kernel": lambda: parity_xor_cuda(out_k, x, None, pt),
                   "copy": lambda: copy.copy_(x)})
    del copy
    r = dict(max_abs_err=0.0, ms=tm["kernel"], plain_ms=tm["plain"],
             bound_ms=b, bound_by=by, library_ms=None, bytes=n_bytes,
             copy_ms=tm["copy"], copy_gbps=2 * x.numel() * 4 / tm["copy"] / 1e6,
             plan_seconds=plan_s, pieces_seconds=pieces_s,
             upload_seconds=upload_s,
             library_note="no one PyTorch call XOR-reduces segments in place")
    log(f"device-to-device copy of the arena ({2 * x.numel() * 4 / 1e9:.3f}"
        f" GB moved): {tm['copy']:.3f} ms, {r['copy_gbps']:.1f} GB/s")
    log(f"parity_xor plan: {plan_s:.4f} s to build, its pieces "
        f"{pieces_s:.4f} s, {upload_s:.4f} s to upload")
    return r


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
    hands it: the whole tree to the grouped block_dist, scatter_save and
    masked_restore, which the path runs, and, per leaf, the block views and
    the raw (R, W) rows, at the SCAR policy's block_rows. Seeded random
    values (the model's init is all zeros)."""
    import torch
    from repro_torch.core.blocks import leaf_block_view, partition_pytree
    from repro_torch.core.policy import CheckpointPolicy
    import numpy as np
    from repro_torch.kernels.block_dist.kernel import block_dist_cuda
    from repro_torch.kernels.block_dist.ops import tree_block_dist
    from repro_torch.kernels.block_dist.ref import (block_dist_ref,
                                                    block_dist_tree_ref)
    from repro_torch.kernels.fused_maintain.kernel import scatter_save_cuda
    from repro_torch.kernels.fused_maintain.ops import tree_scatter_save
    from repro_torch.kernels.fused_maintain.ref import scatter_save_ref
    from repro_torch.kernels.masked_restore.kernel import (
        masked_restore_cuda, masked_restore_tree_cuda)
    from repro_torch.kernels.masked_restore.ref import masked_restore_ref
    from repro_torch.utils.tree import tree_leaves

    br = CheckpointPolicy.scar().block_rows
    shapes = model.init(torch.Generator().manual_seed(1))
    part = partition_pytree(shapes, br)
    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    seen, trees = [], ([], [])
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
        trees[0].append(a)
        trees[1].append(b)
    # the grouped forms the path runs, over the whole MLR tree
    (al, bl), want = trees, block_dist_tree_ref(*trees, part)
    got = tree_block_dist(al, bl, part)
    check(bool(torch.all((got - want).abs() <= 1e-4 * want.abs()))
          and torch.equal(got, tree_block_dist(al, bl, part)),
          "grouped block_dist differs on the MLR tree")
    idx = np.asarray(sorted({l.offset + k for l in part.leaves
                             for k in (0, l.n_blocks - 1)}), np.int64)
    dst = [x.clone() for x in bl]
    tree_scatter_save(dst, al, idx, part)
    for d, x, y, leaf in zip(dst, al, bl, part.leaves):
        want = y.clone().reshape(leaf.rows, leaf.row_width)
        ids = torch.tensor(sorted({0, leaf.n_blocks - 1}), dtype=torch.int32)
        want = scatter_save_ref(want, x.reshape(want.shape), ids.to(device),
                                br)
        check(torch.equal(d.reshape(want.shape), want),
              f"grouped scatter_save differs at {leaf.name}")
    alt = torch.arange(part.total_blocks, device=device) % 2 == 1
    for m in (alt, ~alt):
        for g, x, y, leaf in zip(masked_restore_tree_cuda(bl, al, m, part),
                                 al, bl, part.leaves):
            want = masked_restore_ref(
                y.reshape(leaf.rows, leaf.row_width),
                x.reshape(leaf.rows, leaf.row_width),
                m[leaf.offset:leaf.offset + leaf.n_blocks], br)
            check(torch.equal(g.reshape(want.shape), want),
                  f"grouped masked_restore differs at {leaf.name}")
    log(f"kernels agree with their plain versions on the MLR leaves "
        f"(block_rows {br}; grouped forms over the whole tree too): "
        f"{'; '.join(seen)}")


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
        out = torch.empty((plan.out_words,), dtype=torch.int32, device=device)
        check(torch.equal(parity_xor_cuda(out, x, pk, plan.pieces_on(device)),
                          parity_xor_ref(out.clone(), x, pk, plan.on(device))),
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
    (recovered, info), recovery_s, allocs = timed_allocs(
        lambda: ctl.on_failure(tree, lost, step=steps))
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
           "recovery_seconds": recovery_s, "recovery_allocs": allocs,
           "blocks_per_save": k, "lost_blocks": info["lost_blocks"],
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

    (recovered, info), recovery_s, allocs = timed_allocs(recover)
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
           "recovery_seconds": recovery_s, "recovery_allocs": allocs,
           "blocks_per_save": k,
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
    t0 = time.perf_counter()
    enc, syn = codec.gf_plans(lay)
    enc_plan_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    enc.pieces()
    enc_pieces_s = time.perf_counter() - t0
    n_out = codec.n_groups * m * fe
    log(f"RS({codec.group_size}, {m}) over {fab.domains.n_hosts} hosts: "
        f"{codec.n_groups} groups of <= {codec.members.shape[1]}, rows "
        f"{n_out * 4 / 1e9:.3f} GB")
    x = pack_arena(a_tree, lay)
    results = {}

    def plain(out, src, src2, base, plan):
        return gf256_mac_plan_ref(out, src, src2, base, plan.on(device), 0,
                                  plan.n_rows, 0)

    def launch_record(tm, plan, **extra) -> dict:
        n_bytes = plan.read_bytes() + plan.write_bytes()
        b, by = bound_ms(n_bytes, plan.int_ops(), int_rate)
        return dict(ms=tm["kernel"], plain_ms=tm["plain"], bound_ms=b,
                    bound_by=by, int_ops=plan.int_ops(), bytes=n_bytes,
                    **extra)

    # the encode: bit-exact, row 0 equal to parity_xor's encode
    rows_k = torch.empty((n_out,), dtype=torch.int32, device=device)
    gf256_mac_cuda(rows_k, x, None, None, enc)
    rows_p = plain(torch.empty_like(rows_k), x, None, None, enc)
    check(torch.equal(rows_k, rows_p), "gf256_mac encode differs")
    del rows_p
    xor = torch.empty((codec.n_groups * fe,), dtype=torch.int32,
                      device=device)
    parity_xor_cuda(xor, x, None, encode_plan(lay, codec.layout,
                                              codec.members).pieces_on(device))
    check(torch.equal(rows_k.view(codec.n_groups, m, fe)[:, 0],
                      xor.view(codec.n_groups, fe)),
          "RS row 0 differs from parity_xor's encode of the same members")
    del xor
    tm = in_turns({"plain": lambda: plain(rows_k, x, None, None, enc),
                "kernel": lambda: gf256_mac_cuda(rows_k, x, None, None, enc)},
                  runs=PLAIN_GF256_RUNS)
    results["encode"] = launch_record(tm, enc, groups=codec.n_groups,
                                      plan_seconds=enc_plan_s,
                                      pieces_seconds=enc_pieces_s,
                                      pieces=int(enc.pieces().length.size))

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
                "kernel": lambda: gf256_mac_cuda(synd, x, None, rows_k, syn)},
                  runs=PLAIN_GF256_RUNS)
    del synd
    x[word] ^= 1 << 11
    results["syndromes"] = launch_record(tm, syn)

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
    t0 = time.perf_counter()
    dec.pieces()
    pieces_s = time.perf_counter() - t0
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
                "kernel": lambda: gf256_mac_cuda(out_k, x, rows_k, None, dec)},
                  runs=PLAIN_GF256_RUNS)
    results["decode"] = launch_record(tm, dec, blocks=int(lost.sum()),
                                      plan_seconds=plan_s,
                                      pieces_seconds=pieces_s,
                                      pieces=int(dec.pieces().length.size))
    for name, r in results.items():
        log(f"gf256_mac {name}: kernel {r['ms']:.3f} ms, plain "
            f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms "
            f"({r['bound_by']}; {r['bytes'] / 1e9:.3f} GB, {r['int_ops']:.4g}"
            f" int32 operations at {int_rate / 1e12:.2f} T/s{rate_note(r)}), "
            f"library none (no one PyTorch call does a GF(256) "
            f"multiply-accumulate), max abs err 0")
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
    (recovered, info), recovery_s, allocs = timed_allocs(
        lambda: ctl.on_failure(tree, lost, failed_devices=failed, step=steps))
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
           "recovery_seconds": recovery_s, "recovery_allocs": allocs,
           "hosts": list(pair),
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
    (recovered, info), recovery_s, allocs = timed_allocs(
        lambda: ctl.on_failure(tree, lost, failed_devices=failed, step=steps))
    counts = info["tier_counts"]
    check(counts == plan.counts, "the recovery did not follow its plan")
    check(counts["PARITY"] > 0, f"no block went to the PARITY tier: {counts}")
    check(info["tier_sq"]["PARITY"] == 0.0
          and info["tier_sq"]["PEER_REPLICA"] == 0.0,
          f"live-value tiers perturbed the state: {info['tier_sq']}")
    _check_live_tiers(tree, recovered, plan, part, device)
    out = {"maintain_seconds": maint_s, "save_seconds": save_s,
           "recovery_seconds": recovery_s, "recovery_allocs": allocs,
           "failed_devices": failed.tolist(),
           "lost_blocks": info["lost_blocks"], "tier_counts": counts,
           "parity_groups": fab.parity.n_groups,
           "maintain_bytes_moved": fab.stats["maintain_bytes_moved"],
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    check(out["peak_memory_gb"] < 70, f"peak device memory "
          f"{out['peak_memory_gb']:.1f} GB")
    log(f"per-leaf fabric at 1.54 B values: {json.dumps(out)}")
    return out


# ---------------------------------------------------------------------------
# phases 14-16: the LM serve path (mamba2-370m and qwen2-1.5b), and phase
# 14's cases for phases 19-20
# ---------------------------------------------------------------------------

MAMBA_SERVE = dict(batch=8, seq=2048, new=32)
QWEN_SERVE = dict(batch=4, seq=2048, new=16)
QWEN_RING = dict(batch=1, seq=8192)
ZAMBA2_SERVE = dict(batch=8, seq=2048, new=32)
# phases 24-26: full width, the depth cut to what one 80 GB card holds
# beside the recovery flow's checkpoint and restored tree; qwen3-moe's f32
# route hold on 2 of its 4 layers (the f32 tree of all 4 is 44.8 GB)
QWEN3_MOE_SERVE = dict(batch=4, seq=2048, new=16, layers=4, f32_layers=2)
LLAMA4_SERVE = dict(batch=4, seq=2048, new=16, layers=2)
INTERNVL2_SERVE = dict(batch=4, seq=2048, new=16, layers=4)
# 384 + 32 tokens stay inside whisper's published 448-token decoder context
WHISPER_SERVE = dict(batch=8, frames=1500, seq=384, new=32)
# a kernel against its plain version on the same inputs:
# |got - want| <= RTOL |want| + RTOL max|want| (f32 sums in another order;
# near-zero outputs of a cancelling sum get the scale's share).
# sw_attention's bf16 inputs are read exactly by both versions: the
# kernel's Q K^T products are exact in f32 and its P V splits P into two
# bf16 parts (~2^-17 of P), so the f32 tolerance holds for them too;
# ssd_intra's products are three TF32 products each (~2^-21).
SERVE_RTOL = 1e-4
# end to end, the served weights cast to f32: relative L2 distance of the
# last logits. One f32 rounding apart in each kernel call; the random-weight
# mamba2-370m amplifies a perturbation about 260-fold over its 48 layers
# (on an NVIDIA H100 80GB HBM3 at 700 W: 2.8e-6 after one layer, 7.3e-4
# after 48), and in bf16, where each layer adds its own 1-ulp flips, to
# 0.64 (qwen2-1.5b: 0.017); so the bf16 distance is reported, not held.
LOGITS_F32_REL_TOL = 5e-3


def ssd_intra_counts(B, nc, Q, H, P, N) -> tuple[int, int]:
    """(bytes, f32 FLOPs) of the intra-chunk SSD: each input read once and
    both outputs written once; C B^T once per (batch, chunk) over the causal
    half (it does not depend on the head); per head M's causal half (a
    subtraction, an exp, two products), y = M x over that half, the decay
    weights w and state = B^T (x w)."""
    tri = Q * (Q + 1) // 2
    n_bytes = 4 * (2 * B * nc * Q * H + 2 * B * nc * Q * N
                   + 2 * B * nc * Q * H * P + B * nc * H * N * P)
    flops = B * nc * 2 * tri * N + B * nc * H * (
        4 * tri + 2 * tri * P + 3 * Q + Q * P + 2 * Q * N * P)
    return n_bytes, flops


def ssd_intra_tc_flops(B, nc, Q, H, P, N) -> int:
    """Tensor-core FLOPs of ssd_intra, whose every product is three TF32
    products: C B^T once per (batch, chunk) and y = M x over their causal
    halves, state = B^T (x w) per head."""
    tri = Q * (Q + 1) // 2
    return 3 * B * nc * (2 * tri * N + H * (2 * tri * P + 2 * Q * N * P))


def sw_attention_tc_flops(BH, G, S, Dh, W) -> int:
    """Tensor-core FLOPs of sw_attention's bf16 instance: per visible
    (query, key) pair 2 Dh for Q K^T and 4 Dh for P V as two products (P's
    bf16 high and low parts)."""
    W = min(W, S)
    return 6 * Dh * BH * G * (W * (W + 1) // 2 + (S - W) * W)


def sass_opcodes() -> dict:
    """The SASS opcodes of each kernel function of the built library, in
    order, from ``cuobjdump -sass`` (the toolkit's, beside nvcc)."""
    from repro_torch.kernels import _build
    tool = Path(_build._nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(tool), "-sass", _build.library()._name],
                         check=True, capture_output=True, text=True,
                         timeout=300).stdout
    ops, fn = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            ops[fn] = []
        elif fn is not None and line.strip().startswith("/*") \
                and "*/" in line:
            ins = line.split("*/", 1)[1].strip().rstrip(" ;")
            if ins.startswith("@"):
                ins = ins.split(None, 1)[1] if " " in ins else ins
            if ins:
                ops[fn].append(ins.split()[0].rstrip(";"))
    return ops


def sass_mma_counts() -> dict:
    """HGMMA and HMMA instructions in each kernel function of the built
    library."""
    return {fn: {ins: sum(op.startswith(ins + ".") for op in ops)
                 for ins in ("HGMMA", "HMMA")}
            for fn, ops in sass_opcodes().items()}


def sass_mix(match: tuple) -> dict:
    """Per kernel function whose name holds one of ``match``: its static
    instruction count and its opcodes by kind (the part before the first
    dot), most frequent first."""
    out = {}
    for fn, ops in sass_opcodes().items():
        if any(m in fn for m in match):
            kinds: dict = {}
            for op in ops:
                kinds[op.split(".")[0]] = kinds.get(op.split(".")[0], 0) + 1
            out[fn[:90]] = {"total": len(ops), "by_kind": dict(sorted(
                kinds.items(), key=lambda kv: -kv[1]))}
    return out


def sw_attention_counts(BH, G, S, Dh, W, itemsize) -> tuple[int, int]:
    """(bytes, FLOPs) of banded attention: q, k, v read once, the f32 output
    written once; 4 Dh FLOPs per visible (query, key) pair (q.k and p v),
    the pairs counted exactly: row i sees min(i + 1, W) keys."""
    W = min(W, S)
    band = W * (W + 1) // 2 + (S - W) * W
    n_bytes = itemsize * (BH * G * S * Dh + 2 * BH * S * Dh) \
        + 4 * BH * G * S * Dh
    return n_bytes, 4 * BH * G * Dh * band


def _worst_element(got, want) -> dict:
    """Where |got - want| / (RTOL |want| + RTOL max|want|) is largest: the
    ratio (<= 1 passes), the element's index, got and want there, and
    max|want|."""
    want = want.to(got.dtype)
    top = want.abs().max()
    r = (got - want).abs() / (SERVE_RTOL * (want.abs() + top)).clamp_min(
        1e-30)
    i = int(r.argmax())
    at, rest = [], i
    for n in reversed(r.shape):
        rest, j = divmod(rest, n)
        at.insert(0, j)
    return {"ratio": float(r.reshape(-1)[i]), "at": at,
            "got": float(got.reshape(-1)[i]),
            "want": float(want.reshape(-1)[i]), "want_abs_max": float(top)}


def _close_ratio(got, want) -> float:
    """max |got - want| / (RTOL |want| + RTOL max|want|); <= 1 passes."""
    return _worst_element(got, want)["ratio"]


def _rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


# the served prefills' plain attention materialises (BH, G, S, S) f32
# scores: internvl2-76b's (32, 8, 3072, 3072) are 9.7 GB, several alive at
# once; the route holds take the plain version this many score bytes of
# BH at a time (each (bh) row is computed alone in both)
PLAIN_SCORE_BYTES = 1 << 30


def _plain_rows(q, k, v, window: int):
    """``sw_attention_ref``'s arithmetic for q (1, G, S, Dh), over blocks
    of query rows, each block's scores within ``PLAIN_SCORE_BYTES`` and
    against the keys its band reaches (the rest would be masked to 0)."""
    import torch
    _, G, S, Dh = q.shape
    rows = max(1, PLAIN_SCORE_BYTES // (4 * G * S))
    scale = 1.0 / math.sqrt(Dh)
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    for r0 in range(0, S, rows):
        r1 = min(S, r0 + rows)
        k0 = max(0, r0 - window + 1)
        s = torch.einsum("bgqd,bkd->bgqk", q[:, :, r0:r1].float(),
                         k[:, k0:r1].float()) * scale
        qpos = torch.arange(r0, r1, device=q.device)[:, None]
        kpos = torch.arange(k0, r1, device=q.device)[None, :]
        mask = (kpos <= qpos) & (qpos - kpos < window)
        s = torch.where(mask, s, torch.full((), -1e30, device=s.device))
        pr = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
        pr = torch.where(mask, pr, torch.zeros((), device=s.device))
        pr = pr / torch.clamp_min(torch.sum(pr, dim=-1, keepdim=True), 1e-30)
        out[:, :, r0:r1] = torch.einsum("bgqk,bkd->bgqd", pr,
                                        v[:, k0:r1].float())
    return out


def sw_attention_plain(q, k, v, *, window: int):
    """``sw_attention_ref`` over slices of the BH dim, each slice's scores
    within ``PLAIN_SCORE_BYTES``; where one BH row's (G, S, S) scores alone
    exceed it (command-r-plus-104b's 32k prefill: 51.5 GB a row), row by
    row over blocks of query rows (:func:`_plain_rows`)."""
    import torch
    from repro_torch.kernels.sw_attention.ref import sw_attention_ref
    BH, G, S, _ = q.shape
    if 4 * G * S * S > PLAIN_SCORE_BYTES:
        return torch.cat([_plain_rows(q[i:i + 1], k[i:i + 1], v[i:i + 1],
                                      window) for i in range(BH)])
    step = max(1, PLAIN_SCORE_BYTES // (4 * G * S * S))
    if step >= BH:
        return sw_attention_ref(q, k, v, window=window)
    return torch.cat([sw_attention_ref(q[i:i + step], k[i:i + step],
                                       v[i:i + step], window=window)
                      for i in range(0, BH, step)])


@contextlib.contextmanager
def kernel_route(mode: str):
    """A switch of this script around the ssd_scan and sw_attention
    dispatchers. ``"plain"``: they give CUDA tensors to the plain versions
    (sw_attention's by BH slices, :func:`sw_attention_plain`).
    ``"checked"``: every kernel launch is also run through its plain version
    on the same inputs; yields the tolerance ratios (``_close_ratio``) per
    kernel, and each sw_attention call's worst element
    (``"sw_attention_worst"``, :func:`_worst_element`)."""
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan.ref import ssd_intra_ref
    from repro_torch.kernels.sw_attention import ops as sw_ops
    ssd_cuda, sw_cuda = ssd_ops.ssd_intra_cuda, sw_ops.sw_attention_cuda
    ratios = {"ssd_intra": [], "sw_attention": [], "sw_attention_worst": []}
    if mode == "plain":
        ssd_ops.ssd_intra_cuda = ssd_intra_ref
        sw_ops.sw_attention_cuda = sw_attention_plain
    else:
        def ssd(*args):
            got = ssd_cuda(*args)
            ratios["ssd_intra"].append(max(_close_ratio(g, w) for g, w in zip(
                got, ssd_intra_ref(*args))))
            return got

        def sw(q, k, v, *, window):
            got = sw_cuda(q, k, v, window=window)
            worst = _worst_element(got, sw_attention_plain(q, k, v,
                                                           window=window))
            ratios["sw_attention"].append(worst["ratio"])
            ratios["sw_attention_worst"].append(worst)
            return got
        ssd_ops.ssd_intra_cuda, sw_ops.sw_attention_cuda = ssd, sw
    try:
        yield ratios
    finally:
        ssd_ops.ssd_intra_cuda, sw_ops.sw_attention_cuda = ssd_cuda, sw_cuda


def _ssd_intra_case(dims, gen, device) -> dict:
    """ssd_intra at ``dims`` = (B, nc, Q, H, P, N) against its plain
    version, bit-identical run to run, timed in turns and back to back
    beside its bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.ssd_scan.kernel import ssd_intra_cuda
    from repro_torch.kernels.ssd_scan.ref import ssd_intra_ref
    B, nc, Q, H, P, N = dims

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=device)
    # dt as the model makes it (softplus of a pre-activation), la = dt A
    # with A = -1 (A_log = 0 at init)
    dt = F.softplus(rnd(B, nc, Q, H))
    la = -dt
    ins = (la, dt, rnd(B, nc, Q, H, P), rnd(B, nc, Q, N), rnd(B, nc, Q, N))
    got, want = ssd_intra_cuda(*ins), ssd_intra_ref(*ins)
    ratio = max(_close_ratio(g, w) for g, w in zip(got, want))
    check(ratio <= 1.0, f"ssd_intra {list(dims)} off its plain version: "
          f"{ratio:.3g} of the tolerance")
    again = ssd_intra_cuda(*ins)
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"ssd_intra {list(dims)} differs between two runs")
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    del got, want, again
    t = in_turns({"plain": lambda: ssd_intra_ref(*ins),
                  "kernel": lambda: ssd_intra_cuda(*ins)})
    n_bytes, flops = ssd_intra_counts(*dims)
    tc_flops = ssd_intra_tc_flops(*dims)
    b, by = bound_ms(n_bytes, tc_flops, TF32_TC_FLOPS_PER_S)
    return dict(
        max_abs_err=err, ms=t["kernel"], plain_ms=t["plain"], bound_ms=b,
        bound_by=by, library_ms=None,
        bound_f32_fma_ms=bound_ms(n_bytes, flops, F32_FLOPS_PER_S)[0],
        back_to_back_ms=device_ms(lambda: ssd_intra_cuda(*ins)),
        shape=list(dims), bytes=n_bytes, flops=flops, tc_flops=tc_flops,
        tolerance_ratio=ratio)


def _sw_attention_case(BH, G, S, Dh, W, gen, device,
                       runs: Optional[int] = None) -> dict:
    """sw_attention's bf16 instance at (BH, G, S, Dh, W) against its plain
    version (:func:`sw_attention_plain`, which goes by blocks of rows where
    the scores are large), bit-identical run to run, timed in turns and
    back to back beside its bound and ``F.scaled_dot_product_attention``
    with the band mask (timed only; ``is_causal`` where the band is the
    causal mask and the plain scores would not fit whole, as at
    command-r-plus-104b's 32k prefill). ``runs`` cuts the kernel's and
    SDPA's timed runs and the back-to-back calls; the plain version is then
    timed once, by the call the check reads."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.sw_attention.kernel import sw_attention_cuda
    shape = [BH, G, S, Dh, W]

    def rnd(*shp):
        return torch.randn(shp, generator=gen, device=device).to(
            torch.bfloat16)
    q, k, v = rnd(BH, G, S, Dh), rnd(BH, S, Dh), rnd(BH, S, Dh)
    got = sw_attention_cuda(q, k, v, window=W)
    plain = []
    plain_ms = cuda_ms(lambda: plain.append(
        sw_attention_plain(q, k, v, window=W)), runs=1)[0]
    want = plain.pop()
    ratio = _close_ratio(got, want)
    check(ratio <= 1.0, f"sw_attention {shape} off its plain version: "
          f"{ratio:.3g} of the tolerance")
    check(torch.equal(got, sw_attention_cuda(q, k, v, window=W)),
          f"sw_attention {shape} differs between two runs")
    err = float((got - want).abs().max())
    k4, v4 = k[:, None], v[:, None]
    if W >= S and 4 * G * S * S > PLAIN_SCORE_BYTES:
        mask = dict(is_causal=True)
    else:
        pos = torch.arange(S, device=device)
        mask = dict(attn_mask=(pos[None, :] <= pos[:, None])
                    & (pos[:, None] - pos[None, :] < W))

    def library():
        return F.scaled_dot_product_attention(q, k4, v4, enable_gqa=True,
                                              **mask)
    lib_err = float((library().float() - want).abs().max())
    fns = {"kernel": lambda: sw_attention_cuda(q, k, v, window=W),
           "library": library}
    causal_err = None
    if W >= S and "is_causal" not in mask:
        # the causal band is SDPA's is_causal too: timed beside the mask
        def causal():
            return F.scaled_dot_product_attention(q, k4, v4, enable_gqa=True,
                                                  is_causal=True)
        causal_err = float((causal().float() - want).abs().max())
        fns["causal"] = causal
    del got, want
    if runs is None:
        fns["plain"] = lambda: sw_attention_plain(q, k, v, window=W)
    t = in_turns(fns, runs=runs and {"kernel": runs, "library": runs})
    n_bytes, flops = sw_attention_counts(BH, G, S, Dh, W, 2)
    b, by = bound_ms(n_bytes, flops, BF16_TC_FLOPS_PER_S)
    calls = runs or 10
    out = dict(max_abs_err=err, ms=t["kernel"],
               plain_ms=t.get("plain", plain_ms), bound_ms=b, bound_by=by,
               library_ms=t["library"], library_max_abs_err=lib_err,
               library_mask="is_causal" if "is_causal" in mask else "band",
               library_causal_ms=(t["library"] if "is_causal" in mask
                                  else t.get("causal")),
               library_causal_max_abs_err=(lib_err if "is_causal" in mask
                                           else causal_err),
               back_to_back_ms=device_ms(
                   lambda: sw_attention_cuda(q, k, v, window=W), calls),
               library_back_to_back_ms=device_ms(library, calls),
               shape=shape, bytes=n_bytes, flops=flops,
               tc_flops=sw_attention_tc_flops(BH, G, S, Dh, W),
               tolerance_ratio=ratio)
    del q, k, v, k4, v4, mask
    torch.cuda.empty_cache()
    return out


def _log_case(name: str, r: dict) -> None:
    lib = r["library_ms"]
    causal = r.get("library_causal_ms")
    log(f"{name} {r['shape']}: kernel {r['ms']:.3f} ms "
        f"({r['back_to_back_ms']:.3f} back to back), plain "
        f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms "
        f"({r['bound_by']}), library "
        f"{'none' if lib is None else format(lib, '.3f') + ' ms'}"
        f"{'' if causal is None else ', is_causal ' + format(causal, '.3f') + ' ms'}, max "
        f"abs err {r['max_abs_err']:.3g} ({r['tolerance_ratio']:.3g} of "
        f"the tolerance); tensor-core FLOPs {r['tc_flops'] / 1e9:.3f} G "
        f"with the split's products")


def phase_serve_kernels(device) -> dict:
    """Phase 14: ssd_intra and sw_attention against their plain versions at
    the shapes the serve paths give them: mamba2-370m's and qwen2-1.5b's,
    then zamba2-1.2b's and whisper-medium's, then qwen3-moe-235b-a22b's,
    llama4-maverick-400b-a17b's and internvl2-76b's."""
    import torch
    from repro_torch.configs import get_config

    gen = torch.Generator(device=device).manual_seed(SEED + 14)
    mcfg = get_config("mamba2-370m")
    ssd = {"mamba2": _ssd_intra_case(
        _ssd_dims(mcfg, MAMBA_SERVE["batch"], MAMBA_SERVE["seq"]), gen,
        device)}
    qcfg = get_config("qwen2-1.5b")
    G, Dh, Hk = qcfg.n_heads // qcfg.n_kv_heads, qcfg.head_dim, \
        qcfg.n_kv_heads
    sw = {"causal": _sw_attention_case(
              QWEN_SERVE["batch"] * Hk, G, QWEN_SERVE["seq"], Dh,
              QWEN_SERVE["seq"], gen, device),
          "ring": _sw_attention_case(
              QWEN_RING["batch"] * Hk, G, QWEN_RING["seq"], Dh,
              qcfg.sliding_window, gen, device)}
    # the hybrid's and the encoder-decoder's prefills: Dh 64, G 1
    zcfg, wcfg = get_config("zamba2-1.2b"), get_config("whisper-medium")
    ssd["zamba2"] = _ssd_intra_case(
        _ssd_dims(zcfg, ZAMBA2_SERVE["batch"], ZAMBA2_SERVE["seq"]), gen,
        device)
    for key, cfg, serve in (("zamba2", zcfg, ZAMBA2_SERVE),
                            ("whisper", wcfg, WHISPER_SERVE)):
        sw[key] = _sw_attention_case(
            serve["batch"] * cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads,
            serve["seq"], cfg.head_dim, serve["seq"], gen, device)
    # the MoE and VLM prefills (phases 24-26): Dh 128 at G 16, 5 and 8,
    # internvl2-76b's prompt its 1,024 patches and the 2,048 tokens
    for key, name, serve in (
            ("qwen3_moe", "qwen3-moe-235b-a22b", QWEN3_MOE_SERVE),
            ("llama4", "llama4-maverick-400b-a17b", LLAMA4_SERVE),
            ("internvl2", "internvl2-76b", INTERNVL2_SERVE)):
        cfg = get_config(name)
        S = serve["seq"] + (cfg.n_patches if cfg.family == "vlm" else 0)
        sw[key] = _sw_attention_case(
            serve["batch"] * cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads,
            S, cfg.head_dim, S, gen, device)
    # command-r-plus-104b's 32k causal prefill (phase 29): Dh 128, G 12
    ccfg = get_config("command-r-plus-104b")
    sw["command_r"] = _sw_attention_case(
        ccfg.n_kv_heads, ccfg.n_heads // ccfg.n_kv_heads,
        PERF_VARIANTS["seq"], ccfg.head_dim, PERF_VARIANTS["seq"], gen,
        device, runs=3)
    # the rows of the kernels line are mamba2-370m's and qwen2-1.5b's
    # causal prefill, as before; the other shapes ride along
    results = {"ssd_intra": dict(ssd["mamba2"], zamba2=ssd["zamba2"]),
               "sw_attention": dict(sw["causal"], ring=sw["ring"],
                                    zamba2=sw["zamba2"],
                                    whisper=sw["whisper"],
                                    qwen3_moe=sw["qwen3_moe"],
                                    llama4=sw["llama4"],
                                    internvl2=sw["internvl2"],
                                    command_r=sw["command_r"])}
    for name, r in (("ssd_intra mamba2-370m", ssd["mamba2"]),
                    ("ssd_intra zamba2-1.2b", ssd["zamba2"]),
                    ("sw_attention causal", sw["causal"]),
                    ("sw_attention ring", sw["ring"]),
                    ("sw_attention zamba2-1.2b", sw["zamba2"]),
                    ("sw_attention whisper-medium", sw["whisper"]),
                    ("sw_attention qwen3-moe-235b-a22b", sw["qwen3_moe"]),
                    ("sw_attention llama4-maverick-400b-a17b", sw["llama4"]),
                    ("sw_attention internvl2-76b", sw["internvl2"]),
                    ("sw_attention command-r-plus-104b", sw["command_r"])):
        _log_case(name, r)
    log(f"ssd_intra bound {ssd['mamba2']['bound_ms']:.3f} ms (bytes "
        f"over 3.35 TB/s, or its 3xTF32 products over 495 TFLOP/s); as f32 "
        f"FMA over 67 TFLOP/s {ssd['mamba2']['bound_f32_fma_ms']:.3f}"
        f" ms")
    sass = {name: n for name, n in sass_mma_counts().items()
            if "sw_attention" in name or "ssd_intra" in name}
    log(f"tensor-core instructions in the SASS: {json.dumps(sass)}")
    tc = [n["HGMMA"] for name, n in sass.items() if "sw_attention_tc" in name]
    mma = [n["HMMA"] for name, n in sass.items() if "ssd_intra" in name]
    check(len(tc) == 2 and min(tc) > 0 and mma and min(mma) > 0,
          "the redesigned kernels' SASS lacks HGMMA (sw_attention's bf16 "
          "instances) or HMMA (ssd_intra)")
    results["ssd_intra"]["sass"] = {k: v for k, v in sass.items()
                                    if "ssd_intra" in k}
    results["sw_attention"]["sass"] = {k: v for k, v in sass.items()
                                       if "sw_attention" in k}
    return results


def _ssd_dims(cfg, batch: int, seq: int) -> tuple:
    """(B, nc, Q, H, P, N) of ssd_intra in a prefill of ``cfg``."""
    return (batch, seq // cfg.ssm_chunk, cfg.ssm_chunk, cfg.ssm_heads,
            cfg.ssm_headdim, cfg.ssm_state)


def _timed(fn):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _serve_speeds(srv, ops, cfg, batch, n_new,
                  tokens: Optional[list] = None) -> dict:
    """Warm host-clock seconds of a prefill alone and of a whole
    generate; decode's share is their difference. Then one prefill under
    the profiler: the card's busy seconds and the eight kernels that took
    most of them. The generated tokens are appended to ``tokens`` when it
    is given."""
    _, prefill_s = _timed(lambda: ops.prefill(srv.params, batch, cfg))
    toks, gen_s = _timed(lambda: srv.generate(batch, n_new))
    if tokens is not None:
        tokens.append(toks)
    B, S = batch["tokens"].shape
    return {"prefill_seconds": prefill_s, "generate_seconds": gen_s,
            "prefill_tokens_per_s": B * S / prefill_s,
            "decode_tokens_per_s": B * (n_new - 1) / (gen_s - prefill_s),
            "prefill_profile": device_share(
                lambda: ops.prefill(srv.params, batch, cfg))}


def _hold_routes(ops, cfg, params, batch, calls: dict,
                 f32_layers: Optional[int] = None) -> dict:
    """The served bf16 prefill with every kernel call held against its
    plain version on the same inputs (``calls``: each kernel's calls in
    one prefill); then, with the weights cast to f32, the kernel route's
    last logits against the plain route's: on every layer, on the first
    ``f32_layers`` stacked layers where the f32 tree of all of them would
    not fit beside the bf16 one, or not at all where ``f32_layers`` is 0.
    The bf16 routes' distance is reported."""
    import dataclasses
    import torch
    from repro_torch.utils.tree import tree_map
    with kernel_route("checked") as ratios:
        logits, _ = ops.prefill(params, batch, cfg)
    worst = {}
    for kernel, n in calls.items():
        worst[kernel] = max(ratios[kernel])
        check(len(ratios[kernel]) == n and worst[kernel] <= 1.0,
              f"{cfg.name}: {len(ratios[kernel])} {kernel} calls (not "
              f"{n}), the worst {worst[kernel]:.3g} of the tolerance")
    check(bool(torch.isfinite(logits).all()) and logits.shape == (
        batch["tokens"].shape[0], 1, cfg.vocab), "bad prefill logits")
    with kernel_route("plain"):
        plain, _ = ops.prefill(params, batch, cfg)
    out = {"per_call_worst_ratio": worst,
           "bf16_logits_rel_l2_vs_plain": _rel_l2(logits, plain)}
    del logits, plain
    if f32_layers == 0:
        return out
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    if f32_layers is not None:
        out["f32_route_layers"] = f32_layers
        # the first f32_layers of the stacked layers: views, full width
        params = dict(params, layers=tree_map(lambda x: x[:f32_layers],
                                              params["layers"]))
        cfg32 = dataclasses.replace(cfg32, n_layers=f32_layers)
    p32 = tree_map(lambda x: x.float(), params)
    logits, _ = ops.prefill(p32, batch, cfg32)
    with kernel_route("plain"):
        plain, _ = ops.prefill(p32, batch, cfg32)
    out["f32_logits_rel_l2_vs_plain"] = rel = _rel_l2(logits, plain)
    check(rel <= LOGITS_F32_REL_TOL, f"{cfg.name} in f32: the kernel route "
          f"is {rel:.3g} off the plain route (relative L2)")
    return out


def _hold_recovery(ctl, params, lost, recovered, info: dict,
                   name: str) -> dict:
    """The serve-with-recovery flow's save and restore against their plain
    versions on the served tree, leaf by leaf (a whole second tree would
    not fit beside qwen3-moe's three): the flow applied no perturbation,
    the save (scatter_save) left the checkpoint equal to the params, the
    restore (masked_restore) is the plain restore's and the params' bits.
    Runs after the path's launch counts are read, so none of these
    launches counts."""
    from repro_torch.core.blocks import split_global_mask
    from repro_torch.kernels.masked_restore.ref import masked_restore_ref
    from repro_torch.utils.tree import tree_leaves

    part = ctl.partition
    check(info["applied_sq"] == 0.0, f"{name}: the lossless recovery "
          f"applied a perturbation, applied_sq {info['applied_sq']}")
    masks = split_global_mask(lost.to(bool), part)
    for x, c, r, m, leaf in zip(tree_leaves(params),
                                tree_leaves(ctl.ckpt.values),
                                tree_leaves(recovered), masks, part.leaves):
        check(_same_bits(c, x), f"{name}: the checkpoint of {leaf.name} "
              f"differs from the served params")
        shape2d = (leaf.rows, leaf.row_width)
        want = masked_restore_ref(x.reshape(shape2d), c.reshape(shape2d), m,
                                  part.block_rows).reshape(leaf.shape)
        check(_same_bits(r, want) and _same_bits(r, x), f"{name}: the "
              f"restore of {leaf.name} differs from the plain restore or "
              f"the params")
        del want
    return {"blocks": part.total_blocks}


def _plain_block_sq(leaves, part):
    """Per-block sum of squares of ``leaves`` (f32), as the plain
    block_dist against zeros, in slices of about 2^27 values: row sums,
    then each block's rows."""
    import torch
    out = torch.zeros((part.total_blocks,), dtype=torch.float64,
                      device=leaves[0].device)
    for x, leaf in zip(leaves, part.leaves):
        rows = x.reshape(leaf.rows, leaf.row_width)
        step = max(1, (1 << 27) // max(leaf.row_width, 1))
        sums = torch.cat([rows[i:i + step].float().square().sum(1)
                          for i in range(0, leaf.rows, step)])
        pad = leaf.n_blocks * part.block_rows - leaf.rows
        blocks = torch.nn.functional.pad(sums, (0, pad)).reshape(
            leaf.n_blocks, -1).sum(1)
        out[leaf.offset:leaf.offset + leaf.n_blocks] += blocks.double()
    return out.float()


def _hold_block_dist(params, part, name: str) -> dict:
    """block_dist's per-block ‖x‖² of the served tree (against zeros: views
    of one zero buffer per dtype; bf16 pairs read in place) within rtol
    1e-4 of the plain sum of squares."""
    import torch
    from repro_torch.kernels.block_dist.kernel import block_dist_tree_cuda
    from repro_torch.kernels.leaf_table import block_dist_table
    from repro_torch.utils.tree import tree_leaves

    leaves = tree_leaves(params)
    size: dict = {}
    for x in leaves:
        size[x.dtype] = max(size.get(x.dtype, 0), x.numel())
    zero = {dt: torch.zeros((n,), dtype=dt, device=leaves[0].device)
            for dt, n in size.items()}
    zeros = [zero[x.dtype][:x.numel()].view(x.shape) for x in leaves]
    dk = block_dist_tree_cuda(leaves, zeros, block_dist_table(part))
    del zeros, zero
    rtol = _rel_err(dk, _plain_block_sq(leaves, part))
    check(rtol <= 1e-4, f"{name}: block_dist on the served tree off by "
          f"rtol {rtol}")
    return {"block_dist_rtol": rtol}


def _serve_family(name: str, serve: dict, seed: int, device, launches: dict,
                  path: str, calls: dict) -> dict:
    """One model of ``name`` at full width served from the kernel route
    (``Server.generate`` on ``serve``'s batch), then serve_with_recovery's
    flow (``scar(1.0, 1)``, a 30% loss, partial restore, the same tokens
    again) held by :func:`_hold_recovery`, then the kernel route held
    against the plain route. ``launches[path]`` gets the counts of the two
    generates and the recovery; each serve kernel must have launched
    ``calls[kernel]`` times a prefill, twice, and no more (decode launches
    neither). ``serve["layers"]`` cuts the depth, ``serve["f32_layers"]``
    the f32 route hold's (:func:`_hold_routes`)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.controller import FTController
    from repro_torch.core.policy import CheckpointPolicy
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.kernels import _build
    from repro_torch.models import get_model
    from repro_torch.training.serve import Server
    from repro_torch.utils.tree import tree_leaves

    cfg = get_config(name)
    if "layers" in serve:
        cfg = dataclasses.replace(cfg, n_layers=serve["layers"])
    ops = get_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    params = ops.init_params(torch.Generator(device=device).manual_seed(
        SEED + seed), cfg, device=device)
    init_peak = torch.cuda.max_memory_allocated() / 1e9
    batch = lm_batch(torch.Generator(device=device).manual_seed(
        SEED + seed + 1), cfg, serve["batch"], serve["seq"], device=device)
    _build.reset_launches()
    srv = Server(cfg, params)
    toks0, first_s = _timed(lambda: srv.generate(batch, serve["new"]))
    ctl = FTController(params, CheckpointPolicy.scar(fraction=1.0,
                                                     interval=1))
    ctl.checkpoint_now(1, params)
    lost = ctl.sample_failure(0.3)
    recovered, info = ctl.on_failure(params, lost)
    toks1 = Server(cfg, recovered).generate(batch, serve["new"])
    launches[path] = dict(_build.LAUNCHES)
    check(toks0.shape == (serve["batch"], serve["new"]),
          f"{name}: generated tokens of shape {tuple(toks0.shape)}")
    check(int(lost.sum()) > 0, f"{name}: the failure lost no block")
    check(torch.equal(toks0, toks1), f"{name}: tokens differ after the "
          f"lossless recovery")
    for kernel in ("ssd_intra", "sw_attention"):
        n = launches[path][kernel]
        check(n == 2 * calls.get(kernel, 0),
              f"{name}: {kernel} launched {n} times in two generates, not "
              f"{2 * calls.get(kernel, 0)}")
    served_peak = torch.cuda.max_memory_allocated() / 1e9
    held = _hold_recovery(ctl, params, lost, recovered, info, name)
    part = ctl.partition
    del ctl, recovered
    held.update(_hold_block_dist(params, part, name))
    n_params = sum(x.numel() for x in tree_leaves(params))
    speeds = _serve_speeds(srv, ops, cfg, batch, serve["new"])
    out = {"params": n_params, "layers": cfg.n_layers,
           "init_peak_memory_gb": init_peak,
           "first_generate_seconds": first_s, **speeds,
           "lost_blocks": info["lost_blocks"],
           "applied_sq": info["applied_sq"], "recovery_held": held,
           "served_peak_memory_gb": served_peak}
    if cfg.family in ("moe", "vlm"):
        out.update(_same_logits_twice(ops, cfg, params, batch, name))
    out.update(_hold_routes(ops, cfg, params, batch, calls,
                            serve.get("f32_layers")))
    out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def _same_logits_twice(ops, cfg, params, batch, name: str) -> dict:
    """Two served prefills give the same logits, bit for bit (the MoE
    combine adds in expert order, no atomics)."""
    import torch
    a, _ = ops.prefill(params, batch, cfg)
    b, _ = ops.prefill(params, batch, cfg)
    check(torch.equal(a, b), f"{name}: two prefills' logits differ")
    return {"prefill_logits_bit_identical": True}


def phase_mamba2_serve(device, launches: dict) -> dict:
    """Phase 15: mamba2-370m at full width (48 layers, d 1024, bf16) served
    as :func:`_serve_family` serves a family; ssd_intra once a layer in
    each prefill."""
    from repro_torch.configs import get_config
    cfg = get_config("mamba2-370m")
    out = _serve_family("mamba2-370m", MAMBA_SERVE, 15, device, launches,
                        "mamba2_serve", {"ssd_intra": cfg.n_layers})
    log(f"mamba2-370m serve, batch {MAMBA_SERVE['batch']} x "
        f"{MAMBA_SERVE['seq']} + {MAMBA_SERVE['new']} tokens: "
        f"{json.dumps(out)}")
    return out


def phase_qwen2_serve(device, launches: dict) -> dict:
    """Phase 16: qwen2-1.5b at full width (28 layers, d 1536, GQA 12/2,
    bf16, untied head) served from the kernel route, a ring prefill of
    8,192 tokens and one decode step, then the kernel route held against the
    plain route (the causal and the ring prefill call by call in bf16, the
    causal prefill's logits in f32), and, in f32, the ring decode against a
    ring prefill of the 8,193 tokens; ``launches["qwen2_serve"]`` gets the counts of the
    generate, the ring prefill and its decode."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.kernels import _build
    from repro_torch.models import get_model, transformer
    from repro_torch.training.serve import Server
    from repro_torch.utils.tree import tree_leaves, tree_map

    cfg = get_config("qwen2-1.5b")
    ops = get_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    params = ops.init_params(torch.Generator(device=device).manual_seed(
        SEED + 17), cfg, device=device)
    batch = lm_batch(torch.Generator(device=device).manual_seed(SEED + 18),
                     cfg, QWEN_SERVE["batch"], QWEN_SERVE["seq"],
                     device=device)
    S_ring = QWEN_RING["seq"]
    ring_toks = lm_batch(torch.Generator(device=device).manual_seed(
        SEED + 19), cfg, QWEN_RING["batch"], S_ring + 1,
        device=device)["tokens"]
    spec = transformer.cache_spec(cfg, S_ring, use_window=True)
    long_spec = transformer.cache_spec(cfg, S_ring + 1, use_window=True)
    check(spec.ring and spec.cache_len == cfg.sliding_window,
          f"the ring spec is {spec}")

    def ring(p, c):
        """(decode logits after a ring prefill of S_ring tokens, seconds of
        that prefill)"""
        (_, cache), s = _timed(lambda: transformer.prefill(
            p, {"tokens": ring_toks[:, :S_ring]}, c, spec))
        return ops.decode_step(p, cache, ring_toks[:, S_ring:], c)[0], s

    _build.reset_launches()
    srv = Server(cfg, params)
    toks, first_s = _timed(lambda: srv.generate(batch, QWEN_SERVE["new"]))
    ring_decode, ring_s = ring(params, cfg)
    launches["qwen2_serve"] = dict(_build.LAUNCHES)
    check(toks.shape == (QWEN_SERVE["batch"], QWEN_SERVE["new"]),
          f"generated tokens of shape {tuple(toks.shape)}")
    check(launches["qwen2_serve"]["sw_attention"] == 2 * cfg.n_layers,
          f"sw_attention launched {launches['qwen2_serve']['sw_attention']} "
          f"times, not once per layer and prefill")
    longer = transformer.prefill(params, {"tokens": ring_toks}, cfg,
                                 long_spec)[0]
    check(bool(torch.isfinite(ring_decode).all()), "bad ring decode logits")
    out = {"params": sum(x.numel() for x in tree_leaves(params)),
           "first_generate_seconds": first_s,
           **_serve_speeds(srv, ops, cfg, batch, QWEN_SERVE["new"]),
           "ring_prefill_tokens": S_ring, "ring_prefill_seconds": ring_s,
           "ring_prefill_tokens_per_s": S_ring / ring_s,
           "bf16_ring_decode_rel_l2_vs_prefill": _rel_l2(ring_decode,
                                                         longer),
           "served_peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           **_hold_routes(ops, cfg, params, batch,
                          {"sw_attention": cfg.n_layers})}
    del ring_decode, longer
    with kernel_route("checked") as ratios:
        transformer.prefill(params, {"tokens": ring_toks[:, :S_ring]}, cfg,
                            spec)
    out["ring_per_call_worst_ratio"] = worst = max(ratios["sw_attention"])
    check(len(ratios["sw_attention"]) == cfg.n_layers and worst <= 1.0,
          f"the bf16 ring prefill: {len(ratios['sw_attention'])} "
          f"sw_attention calls, the worst {worst:.3g} of the tolerance")
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = tree_map(lambda x: x.float(), params)
    del params, srv
    torch.cuda.empty_cache()
    ring_decode, _ = ring(p32, cfg32)
    longer = transformer.prefill(p32, {"tokens": ring_toks}, cfg32,
                                 long_spec)[0]
    out["f32_ring_decode_rel_l2_vs_prefill"] = rel = _rel_l2(ring_decode,
                                                            longer)
    check(rel <= LOGITS_F32_REL_TOL, f"in f32 the ring decode is {rel:.3g} "
          f"off the longer ring prefill (relative L2)")
    out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"qwen2-1.5b serve, batch {QWEN_SERVE['batch']} x "
        f"{QWEN_SERVE['seq']} + {QWEN_SERVE['new']} tokens, ring "
        f"{S_ring} + 1: {json.dumps(out)}")
    return out


# ---------------------------------------------------------------------------
# phases 19-20: the hybrid (zamba2-1.2b) and encoder-decoder
# (whisper-medium) families served
# ---------------------------------------------------------------------------

def phase_zamba2_serve(device, launches: dict, card: str) -> dict:
    """Phase 19: zamba2-1.2b at full width (38 Mamba2 layers, d 2048, the
    shared block applied 7 times, bf16) served, the recovery flow and the
    route hold; ssd_intra once a layer and sw_attention once an
    application of the shared block, in each prefill."""
    from repro_torch.configs import get_config
    from repro_torch.models import hybrid
    cfg = get_config("zamba2-1.2b")
    t0 = time.perf_counter()
    out = _serve_family("zamba2-1.2b", ZAMBA2_SERVE, 190, device, launches,
                        "zamba2_serve", {"ssd_intra": cfg.n_layers,
                                         "sw_attention":
                                         hybrid.n_segments(cfg)})
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 19: zamba2-1.2b serve, batch {ZAMBA2_SERVE['batch']} x "
        f"{ZAMBA2_SERVE['seq']} + {ZAMBA2_SERVE['new']} tokens, on {card}: "
        f"{json.dumps(out)}")
    return out


def phase_whisper_serve(device, launches: dict, card: str) -> dict:
    """Phase 20: whisper-medium at full width (24 encoder and 24 decoder
    layers, d 1024, vocab 51,865, bf16) served on 1,500 frames, the
    recovery flow and the route hold; sw_attention once a decoder layer in
    each prefill, ssd_intra never."""
    from repro_torch.configs import get_config
    cfg = get_config("whisper-medium")
    check(cfg.enc_seq == WHISPER_SERVE["frames"],
          f"whisper-medium's enc_seq is {cfg.enc_seq}")
    t0 = time.perf_counter()
    out = _serve_family("whisper-medium", WHISPER_SERVE, 200, device,
                        launches, "whisper_serve",
                        {"sw_attention": cfg.n_layers})
    out["seconds"] = time.perf_counter() - t0
    out["prefill_frames_per_s"] = (WHISPER_SERVE["batch"] * cfg.enc_seq
                                   / out["prefill_seconds"])
    log(f"phase 20: whisper-medium serve, batch {WHISPER_SERVE['batch']} x "
        f"({cfg.enc_seq} frames, {WHISPER_SERVE['seq']} tokens) + "
        f"{WHISPER_SERVE['new']} tokens, on {card}: {json.dumps(out)}")
    return out


def family_phases(device, launches: dict, card: str) -> dict:
    import torch
    out = {"zamba2_serve": phase_zamba2_serve(device, launches, card)}
    gc.collect()
    torch.cuda.empty_cache()
    out["whisper_serve"] = phase_whisper_serve(device, launches, card)
    gc.collect()
    torch.cuda.empty_cache()
    return out


def families_only(device, card: str) -> int:
    """``--families``: phase 14 and phases 19-20 alone. Its last line says
    that it is this run, not the full one."""
    import torch
    kernels = phase_serve_kernels(device)
    launches: dict = {}
    out = family_phases(device, launches, card)
    log(json.dumps({"launches": launches, "serve_kernels": kernels}))
    log(card)
    log(json.dumps({"families_only": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}, "phases": list(out)}))
    return 0


# ---------------------------------------------------------------------------
# phases 24-26: the MoE (qwen3-moe-235b-a22b, llama4-maverick-400b-a17b) and
# VLM (internvl2-76b) families served
# ---------------------------------------------------------------------------

def phase_qwen3_moe_serve(device, launches: dict, card: str) -> dict:
    """Phase 24: qwen3-moe-235b-a22b at full width (d 4096, 128 experts
    top-8 of d_ff 1536, GQA 64/4, bf16) with 4 of its 94 layers, served as
    :func:`_serve_family` serves a family; sw_attention once a layer in
    each prefill."""
    t0 = time.perf_counter()
    out = _serve_family("qwen3-moe-235b-a22b", QWEN3_MOE_SERVE, 240, device,
                        launches, "qwen3_moe_serve",
                        {"sw_attention": QWEN3_MOE_SERVE["layers"]})
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 24: qwen3-moe-235b-a22b serve ({QWEN3_MOE_SERVE['layers']} "
        f"layers), batch {QWEN3_MOE_SERVE['batch']} x "
        f"{QWEN3_MOE_SERVE['seq']} + {QWEN3_MOE_SERVE['new']} tokens, on "
        f"{card}: {json.dumps(out)}")
    return out


def phase_llama4_serve(device, launches: dict, card: str) -> dict:
    """Phase 25: llama4-maverick-400b-a17b at full width (d 5120, GQA 40/8,
    one dense layer of d_ff 16384 and one MoE layer of 128 experts top-1 of
    d_ff 8192 with the shared expert, the untied head; bf16, 18.7 G values,
    37.4 GB) served: two generates, the same tokens, each prefill's logits
    the same bits; every sw_attention call of a bf16 prefill held against
    its plain version, the bf16 distance of the last logits to the plain
    route reported. Neither the recovery flow (the checkpoint and the
    restored tree would be two more 37.4 GB trees) nor the f32 route (74.7
    GB) fits beside it: phase 23 holds both on the reduced config.
    ``launches["llama4_serve"]`` gets the two generates' counts."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.kernels import _build
    from repro_torch.models import get_model
    from repro_torch.training.serve import Server
    from repro_torch.utils.tree import tree_leaves

    name, serve = "llama4-maverick-400b-a17b", LLAMA4_SERVE
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(name), n_layers=serve["layers"])
    ops = get_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    params = ops.init_params(torch.Generator(device=device).manual_seed(
        SEED + 250), cfg, device=device)
    init_peak = torch.cuda.max_memory_allocated() / 1e9
    batch = lm_batch(torch.Generator(device=device).manual_seed(SEED + 251),
                     cfg, serve["batch"], serve["seq"], device=device)
    _build.reset_launches()
    srv = Server(cfg, params)
    toks0, first_s = _timed(lambda: srv.generate(batch, serve["new"]))
    toks1 = srv.generate(batch, serve["new"])
    launches["llama4_serve"] = dict(_build.LAUNCHES)
    check(toks0.shape == (serve["batch"], serve["new"]),
          f"{name}: generated tokens of shape {tuple(toks0.shape)}")
    check(torch.equal(toks0, toks1), f"{name}: two generates differ")
    n = launches["llama4_serve"]["sw_attention"]
    check(n == 2 * cfg.n_layers and launches["llama4_serve"]["ssd_intra"]
          == 0, f"{name}: sw_attention launched {n} times in two "
          f"generates, not {2 * cfg.n_layers}")
    out = {"params": sum(x.numel() for x in tree_leaves(params)),
           "layers": cfg.n_layers, "init_peak_memory_gb": init_peak,
           "first_generate_seconds": first_s,
           **_serve_speeds(srv, ops, cfg, batch, serve["new"]),
           "served_peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           **_same_logits_twice(ops, cfg, params, batch, name),
           **_hold_routes(ops, cfg, params, batch,
                          {"sw_attention": cfg.n_layers}, f32_layers=0)}
    out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 25: {name} serve ({cfg.n_layers} layers: one dense + MoE "
        f"pair), batch {serve['batch']} x {serve['seq']} + {serve['new']} "
        f"tokens, on {card}: {json.dumps(out)}")
    return out


def phase_internvl2_serve(device, launches: dict, card: str) -> dict:
    """Phase 26: internvl2-76b at full width (d 8192, GQA 64/8, d_ff
    28672, the untied head, the projector of 3200; bf16) with 4 of its 80
    layers, served on 1,024 patches and 2,048 tokens a prompt (3,072
    positions, under its 4,096 window), as :func:`_serve_family` serves a
    family; sw_attention once a layer in each prefill."""
    from repro_torch.configs import get_config
    cfg = get_config("internvl2-76b")
    t0 = time.perf_counter()
    out = _serve_family("internvl2-76b", INTERNVL2_SERVE, 260, device,
                        launches, "internvl2_serve",
                        {"sw_attention": INTERNVL2_SERVE["layers"]})
    out["seconds"] = time.perf_counter() - t0
    out["prefill_positions_per_s"] = (
        INTERNVL2_SERVE["batch"] * (INTERNVL2_SERVE["seq"] + cfg.n_patches)
        / out["prefill_seconds"])
    log(f"phase 26: internvl2-76b serve ({INTERNVL2_SERVE['layers']} "
        f"layers), batch {INTERNVL2_SERVE['batch']} x ({cfg.n_patches} "
        f"patches, {INTERNVL2_SERVE['seq']} tokens) + "
        f"{INTERNVL2_SERVE['new']} tokens, on {card}: {json.dumps(out)}")
    return out


def moe_vlm_phases(device, launches: dict, card: str) -> dict:
    import torch
    out = {}
    for key, phase in (("qwen3_moe_serve", phase_qwen3_moe_serve),
                       ("llama4_serve", phase_llama4_serve),
                       ("internvl2_serve", phase_internvl2_serve)):
        out[key] = phase(device, launches, card)
        gc.collect()
        torch.cuda.empty_cache()
    return out


def moe_vlm_only(device, card: str) -> int:
    """``--moe-vlm``: phase 14 and phases 24-26 alone. Its last line says
    that it is this run, not the full one."""
    import torch
    kernels = phase_serve_kernels(device)
    launches: dict = {}
    out = moe_vlm_phases(device, launches, card)
    log(json.dumps({"launches": launches, "serve_kernels": kernels}))
    log(card)
    log(json.dumps({"moe_vlm_only": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}, "phases": list(out)}))
    return 0


# ---------------------------------------------------------------------------
# phase 17: the LM trainer with SCAR fault tolerance
# ---------------------------------------------------------------------------

TRAIN = dict(batch=4, seq=2048, steps=8)
# two hosts lost together at step 5: block replicas are rack-anti-affine,
# so one host's loss recovers every block from PEER_REPLICA; with hosts 0
# and 2 (one in each rack) down, blocks whose primary and replica both sat
# on them recover from PARITY and RUNNING_CKPT too
TRAIN_SCHEDULE = [(5, "host", 0), (5, "host", 2)]
TRAIN_SMALL = dict(batch=2, seq=64, steps=6)
LOSS_RTOL = 1e-4


def _train_loop(cfg, device, *, arena_state: bool = True,
                schedule=None, per_layer: bool = True, recorder=None):
    """``TrainLoop`` with adamw(3e-4), ``CheckpointPolicy.scar(0.125, 2)``
    and ``FabricConfig()``."""
    from repro_torch.core.policy import CheckpointPolicy
    from repro_torch.fabric import FabricConfig
    from repro_torch.optim import adamw
    from repro_torch.training import TrainLoop, TrainLoopConfig
    return TrainLoop(cfg, adamw(3e-4), TrainLoopConfig(
        policy=CheckpointPolicy.scar(fraction=0.125, interval=2),
        fabric=FabricConfig(), arena_state=arena_state,
        fail_schedule=schedule, per_layer_leaves=per_layer,
        recorder=recorder), device=device)


def _check_recovery(info: dict, where: str) -> None:
    tiers = info["tier_counts"]
    lost = sum(n for t, n in tiers.items() if t != "SURVIVOR")
    check(lost == info["lost_blocks"] > 0,
          f"{where}: tier counts {tiers} do not sum to the "
          f"{info['lost_blocks']} lost blocks")
    check(info["tier_sq"]["PEER_REPLICA"] == 0.0
          and info["tier_sq"]["PARITY"] == 0.0,
          f"{where}: live tiers applied a perturbation {info['tier_sq']}")


def _same_bits(a, b) -> bool:
    """Bit equality of two tensors of one dtype (NaNs and signed zeros
    included)."""
    import torch
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    dt = ints[a.element_size()]
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.reshape(-1).view(dt), b.reshape(-1).view(dt))


def _rel_err(got, want) -> float:
    return float(((got - want).abs() / want.abs().clamp_min(1e-30)).max())


def check_train_kernels(loop, arena, info: dict, device) -> dict:
    """The five fabric kernels of the training path against their plain
    versions on the trained model's own tensors: the live bf16 arena, the
    checkpoint arena and the sweep's replica and parity, at the path's
    shapes. The sweep (arena_maintain: parity, replica and scores) and the
    parity encode (parity_xor) over the whole arena, the save of the
    sweep's top-scored eighth (arena_scatter), then phase 17(a)'s two-host
    loss replayed tier by tier: PEER_REPLICA from the replica arena and
    RUNNING_CKPT from the checkpoint (masked_restore), PARITY rebuilt from
    the surviving members (parity_xor) and the per-block ‖δ′‖² of the
    result (block_dist). Words and restored values bit-exact, scores and
    distances within rtol 1e-4. Runs after the path's launch counts are
    read, so none of these launches counts."""
    import numpy as np
    import torch
    from repro_torch.core.arena import arena_restore, arena_restore_ref
    from repro_torch.core.blocks import masked_total
    from repro_torch.fabric.parity import unpack_segments_into
    from repro_torch.fabric.tiers import RecoveryTier
    from repro_torch.kernels import _build
    from repro_torch.kernels.block_dist.kernel import block_dist_tree_cuda
    from repro_torch.kernels.block_dist.ref import block_dist_tree_ref
    from repro_torch.kernels.fused_maintain.kernel import (arena_maintain_cuda,
                                                           arena_scatter_cuda)
    from repro_torch.kernels.fused_maintain.ops import (save_ranges,
                                                        scatter_plan)
    from repro_torch.kernels.fused_maintain.ref import (arena_maintain_ref,
                                                        arena_scatter_ref)
    from repro_torch.kernels.leaf_table import block_dist_table
    from repro_torch.kernels.masked_restore.kernel import \
        masked_restore_tree_cuda
    from repro_torch.kernels.masked_restore.ref import tree_masked_restore_ref
    from repro_torch.kernels.parity_xor.kernel import parity_xor_cuda
    from repro_torch.kernels.parity_xor.ops import (encode_plan,
                                                    reconstruct_plan)
    from repro_torch.kernels.parity_xor.ref import parity_xor_ref
    from repro_torch.utils.tree import tree_leaves, tree_unflatten, \
        tree_flatten

    ctl = loop.controller
    fab, part = ctl.fabric, ctl.partition
    lay, codec = fab.arena_layout, fab.parity
    x, z = arena, ctl._ckpt_arena
    rep = fab.replicas.arena_local()
    n_par = codec.n_groups * codec.layout.frame_elems
    out = {}

    # arena_maintain: the sweep of the run's last step, again
    t = fab._arena_maintain_fn().plan.on(device)
    pk = torch.zeros((n_par,), dtype=torch.int32, device=device)
    pp = torch.zeros_like(pk)
    rk, rp = torch.zeros_like(x), torch.zeros_like(x)
    sk = arena_maintain_cuda(x, z, t, pk, rk)
    sp = arena_maintain_ref(x, z, t, pp, rp)
    check(_same_bits(pk, pp) and _same_bits(rk, rp),
          "training arena: arena_maintain parity or replica differs")
    out["arena_maintain_scores_rtol"] = _rel_err(sk, sp)
    check(out["arena_maintain_scores_rtol"] <= 1e-4,
          f"training arena: arena_maintain scores off by rtol "
          f"{out['arena_maintain_scores_rtol']}")
    check(_same_bits(pk, codec.parity.reshape(-1)),
          "training arena: the run's parity is not the sweep's of its arena")
    check(_same_bits(rep, x), "training arena: the run's replica is not "
          "its live arena")
    del pp, rk, rp, sp

    # parity_xor: the whole-arena encode equals the sweep's parity
    plan = encode_plan(lay, codec.layout, codec.members)
    ek = parity_xor_cuda(torch.empty_like(pk), x, None,
                         plan.pieces_on(device))
    check(_same_bits(ek, pk), "training arena: parity_xor encode differs "
          "from the sweep's parity")
    check(_same_bits(parity_xor_ref(torch.empty_like(pk), x, None,
                                    plan.on(device)), ek),
          "training arena: parity_xor encode differs from its plain version")
    del ek, pk, plan

    # arena_scatter: the save of the sweep's top-scored eighth
    ids = torch.topk(sk, part.total_blocks // 8).indices.cpu().numpy()
    st = scatter_plan(*save_ranges(lay, np.sort(ids)), device)
    check(_same_bits(arena_scatter_cuda(z.clone(), x, st),
                     arena_scatter_ref(z.clone(), x, st)),
          "training arena: arena_scatter differs")
    out["saved_blocks"] = int(ids.size)
    del sk, st

    # the two-host loss of phase 17(a) replayed: the view still holds
    # both hosts dead, the placement unchanged (a non-elastic fabric)
    failed = np.unique(np.concatenate([fab.domains.devices_in("host", h)
                                       for _, _, h in TRAIN_SCHEDULE]))
    lost = np.isin(fab.view.homes, failed)
    plan = fab.planner.plan(lost, failed, fab.last_maintained_step)
    check(plan.counts == info["tier_counts"], f"the replayed loss plans "
          f"{plan.counts}, the run's recovery {info['tier_counts']}")
    params = ctl.unpack_live(x)
    m_rep = plan.mask(RecoveryTier.PEER_REPLICA)
    n0 = _build.LAUNCHES["masked_restore"]
    got = arena_restore(params, rep, m_rep, lay)
    check(_build.LAUNCHES["masked_restore"] == n0 + 1,
          "the PEER_REPLICA restore did not make one launch")
    check(all(_same_bits(g, w) for g, w in zip(
        tree_leaves(got), tree_leaves(arena_restore_ref(params, rep, m_rep,
                                                         lay)))),
          "training arena: the PEER_REPLICA restore differs")

    m_par = plan.mask(RecoveryTier.PARITY)
    home_alive = fab.view.alive[fab.view.homes]
    available = (plan.tiers < int(RecoveryTier.PARITY)) & (
        home_alive | (plan.tiers == int(RecoveryTier.PEER_REPLICA)))
    rplan, blocks = reconstruct_plan(
        lay, codec.layout, codec.group_of, codec.members,
        np.nonzero(m_par)[0], codec.member_mask(available))
    words = parity_xor_cuda(torch.empty((rplan.out_words,), dtype=torch.int32,
                                        device=device),
                            rep, codec.parity.reshape(-1),
                            rplan.pieces_on(device))
    check(_same_bits(words, parity_xor_ref(
        torch.empty_like(words), rep, codec.parity.reshape(-1),
        rplan.on(device))), "training arena: the PARITY rebuild differs")
    got = unpack_segments_into(got, blocks, words, lay)
    out["parity_words"] = int(words.numel())
    del words, rplan

    m_ck = torch.from_numpy(plan.mask(RecoveryTier.RUNNING_CKPT)).to(device)
    ckpt = ctl.ckpt.values
    flat, treedef = tree_flatten(got)
    want = tree_leaves(tree_masked_restore_ref(got, ckpt, m_ck, part))
    got = tree_unflatten(treedef, masked_restore_tree_cuda(
        flat, tree_leaves(ckpt), m_ck, part))
    check(all(_same_bits(g, w) for g, w in zip(tree_leaves(got), want)),
          "training arena: the RUNNING_CKPT restore differs")
    del flat, want, ckpt

    # block_dist: ‖δ′‖² per block of the recovered tree
    dk = block_dist_tree_cuda(tree_leaves(got), tree_leaves(params),
                              block_dist_table(part))
    dp = block_dist_tree_ref(tree_leaves(got), tree_leaves(params), part)
    out["block_dist_rtol"] = _rel_err(dk, dp)
    check(out["block_dist_rtol"] <= 1e-4, f"training arena: block_dist off "
          f"by rtol {out['block_dist_rtol']}")
    sq = {t.name: float(masked_total(dp, torch.from_numpy(
        plan.mask(t)).to(device))) for t in (RecoveryTier.PEER_REPLICA,
                                             RecoveryTier.PARITY,
                                             RecoveryTier.RUNNING_CKPT)}
    check(sq["PEER_REPLICA"] == sq["PARITY"] == 0.0,
          f"training arena: the live tiers' plain ‖δ′‖² {sq}")
    out["plain_tier_sq"] = sq
    log(f"the training path's kernels against their plain versions on the "
        f"trained bf16 arena ({lay.total_words} words, {part.total_blocks} "
        f"blocks): {json.dumps(out)}")
    return out


def _train_full(name: str, device, launches: dict, path: str, shape: dict,
                seed: int = 0) -> dict:
    """``name`` at full width (and depth, unless ``shape["layers"]`` cuts
    it) trained arena-resident under SCAR and ``FabricConfig()`` through
    phase 17(a)'s two-host loss: ``shape["steps"]`` steps of
    ``shape["batch"]`` sequences of ``shape["seq"]`` tokens (and a VLM's
    patches) from ``ShardedLMDataset(seed=0)``; ``launches[path]`` gets
    the counts of the run. Checked: finite losses, step 1's within 1.0 of
    ln V, every maintain resident, the recovery's tiers
    (:func:`_check_recovery`), the five fabric kernels held against their
    plain versions on the run's own arena afterwards."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import ShardedLMDataset
    from repro_torch.kernels import _build
    from repro_torch.telemetry import Recorder
    from repro_torch.training import ArenaTrainState

    cfg = get_config(name)
    if shape.get("layers"):
        cfg = dataclasses.replace(cfg, n_layers=shape["layers"])
    log(f"{name}: device memory before the run "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated, "
        f"{torch.cuda.memory_reserved() / 1e9:.2f} GB reserved")
    torch.cuda.reset_peak_memory_stats()
    rec = Recorder()
    loop = _train_loop(cfg, device, schedule=TRAIN_SCHEDULE, recorder=rec)
    t0 = time.perf_counter()
    state = loop.init_state(torch.Generator(device=device).manual_seed(
        SEED + seed))
    init_s = time.perf_counter() - t0
    check(isinstance(state, ArenaTrainState), f"{name}: the trainer did not "
          f"take the arena-resident path")
    ds = ShardedLMDataset(cfg, shape["batch"], shape["seq"], seed=0,
                          device=device)
    it = iter(ds)
    _build.reset_launches()
    after_step = []
    t0 = time.perf_counter()
    state = loop.run(state, it, shape["steps"], on_step=lambda i, _: (
        after_step.append(torch.cuda.memory_allocated() / 1e9)))
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches[path] = dict(_build.LAUNCHES)
    losses = [m["loss"] for m in loop.metrics]
    check(all(math.isfinite(x) for x in losses), f"{name}: losses {losses}")
    check(abs(losses[0] - math.log(cfg.vocab)) <= 1.0,
          f"{name}: step 1's loss {losses[0]} is not within 1.0 of ln V = "
          f"{math.log(cfg.vocab):.3f}")
    fab = loop.controller.fabric
    check(fab.stats["arena_resident_maintains"]
          == fab.stats["arena_maintains"] > 0,
          f"{name}: the hot path packed: "
          f"{fab.stats['arena_resident_maintains']} resident of "
          f"{fab.stats['arena_maintains']} sweeps")
    fails = [(m["step"], f) for m in loop.metrics
             for f in m.get("failures", [])]
    check(len(fails) == 1, f"{name}: {len(fails)} recoveries, not 1")
    info = fails[0][1]
    _check_recovery(info, f"{name} training")
    for kernel in TRAIN_KERNELS:
        check(launches[path][kernel] > 0,
              f"{kernel} was not launched on the {path} path")
    clean = [m["seconds"] for m in loop.metrics if "failures" not in m]
    step_s = statistics.median(clean)
    summ = loop.overhead_summary()
    peak = torch.cuda.max_memory_allocated() / 1e9
    # one more clean step under the profiler: the card's busy share; one
    # under cProfile: where the host's time goes
    loop.loop_cfg.fail_schedule = None
    holder = {"state": state}
    t0 = time.perf_counter()
    share = device_share(lambda: holder.update(
        state=loop.run(holder["state"], it, 1)))
    share["seconds_with_processing"] = time.perf_counter() - t0
    host = host_profile(lambda: holder.update(
        state=loop.run(holder["state"], it, 1)))
    part = loop.controller.partition
    # the kernels against their plain versions on the run's own bf16
    # arena; the optimizer's moments go first (the checks need room)
    arena = holder["state"].arena
    del state, holder
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    held = check_train_kernels(loop, arena, info, device)
    held["seconds"] = time.perf_counter() - t0
    del arena
    tokens = shape["batch"] * shape["seq"]
    out = {"params": sum(math.prod(l.shape) for l in part.leaves),
           "leaves": len(part.leaves), "blocks": part.total_blocks,
           "arena_gb": loop.arena_layout.nbytes / 1e9,
           "parity_gb": fab.redundancy_nbytes()["parity"] / 1e9,
           "microbatch": cfg.microbatch,
           "init_seconds": init_s, "run_seconds": run_s,
           "losses": losses, "step_seconds": [m["seconds"]
                                              for m in loop.metrics],
           "median_step_seconds": step_s,
           "tokens_per_second": tokens / step_s,
           "overhead_p50": summ["overhead_seconds_p50"],
           "overhead_p95": summ["overhead_seconds_p95"],
           "overhead_phases_p50": {k: v["p50"]
                                   for k, v in summ["phases"].items()},
           "maintain_bytes_per_step": summ["maintain_bytes_per_step"],
           "recovery_step": fails[0][0],
           "recovery_seconds": rec.tracer.durations("recovery"),
           "lost_blocks": info["lost_blocks"],
           "tier_counts": info["tier_counts"], "tier_sq": info["tier_sq"],
           "fallbacks": len(info["tier_fallbacks"]),
           "peak_memory_gb": peak, "memory_after_step_gb": after_step,
           "clean_step_profile": share,
           "clean_step_host_profile": host,
           "events": sorted({e["kind"] for e in rec.events}),
           "kernels_held": held}
    if cfg.family == "audio":
        out["frames_per_second"] = shape["batch"] * cfg.enc_seq / step_s
    if cfg.family == "vlm":
        # the patch prefix and the tokens: the positions the stack runs
        out["positions_per_second"] = (shape["batch"]
                                       * (cfg.n_patches + shape["seq"])
                                       / step_s)
    out["layers"] = cfg.n_layers
    return out


def phase_train(device, launches: dict) -> dict:
    """Phase 17(a): qwen2-1.5b at full width and depth trained
    arena-resident under SCAR and ``FabricConfig()`` through a two-host
    loss; ``launches["train"]`` gets the counts of the 8-step run."""
    out = _train_full("qwen2-1.5b", device, launches, "train", TRAIN)
    log(f"qwen2-1.5b training, batch {TRAIN['batch']} x {TRAIN['seq']}, "
        f"{TRAIN['steps']} steps: {json.dumps(out)}")
    return out


def _arena_against_pytree(cfg, device, shape: dict, seed: int,
                          what: str) -> dict:
    """``cfg`` trained arena-resident and on the PyTree path in turn from
    the same seeded weights and ``shape["batch"]`` x ``shape["seq"]``
    batches, 4 steps each, deterministic algorithms on: losses, the
    checkpoint arena, ``saved_iter`` and the final parameters
    bit-equal, at least one save made."""
    import torch
    from repro_torch.core.arena import pack_arena
    from repro_torch.data import ShardedLMDataset
    from repro_torch.training import ArenaTrainState, TrainState

    torch.use_deterministic_algorithms(True)
    try:
        runs = {}
        for arena in (True, False):
            loop = _train_loop(cfg, device, arena_state=arena)
            state = loop.init_state(
                torch.Generator(device=device).manual_seed(seed))
            check(isinstance(state, ArenaTrainState if arena
                             else TrainState), f"{what}: wrong state form")
            ds = ShardedLMDataset(cfg, shape["batch"], shape["seq"],
                                  seed=0, device=device)
            state = loop.run(state, iter(ds), 4)
            losses = [m["loss"] for m in loop.metrics]
            ctl = loop.controller
            final = (state.arena if arena
                     else pack_arena(state.params, ctl.arena_layout))
            runs[arena] = {"losses": losses,
                           "ckpt": ctl._ckpt_arena.clone(),
                           "saved": ctl.ckpt.saved_iter.clone(),
                           "final": final.clone(),
                           "saves": ctl.stats["saves"]}
            del loop, state, ctl, final
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        torch.use_deterministic_algorithms(False)
    a, t = runs[True], runs[False]
    check(a["saves"] >= 1, f"{what}: no save")
    check(a["losses"] == t["losses"]
          and all(math.isfinite(v) for v in a["losses"]),
          f"{what}: losses arena {a['losses']}, PyTree {t['losses']}")
    for k in ("ckpt", "saved", "final"):
        check(torch.equal(a[k], t[k]), f"{what}: the {k} differs between "
              f"the arena and the PyTree paths")
    return {"losses": a["losses"], "saves": a["saves"],
            "ckpt_words": a["ckpt"].numel()}


def phase_train_bit_equal(device) -> dict:
    """Phase 17(b): qwen2-1.5b at full width with 4 layers, arena-resident
    and on the PyTree path in turn (:func:`_arena_against_pytree`)."""
    import dataclasses
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config("qwen2-1.5b"), n_layers=4)
    out = _arena_against_pytree(cfg, device, TRAIN, SEED + 17,
                                "qwen2-1.5b (4 layers)")
    log(f"qwen2-1.5b (4 layers) arena against PyTree, bit-equal: "
        f"{json.dumps(out)}")
    return out


def _small_train(name: str, device, params_np) -> dict:
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import ShardedLMDataset

    cfg = get_config(name, reduced=True)
    loop = _train_loop(cfg, device, per_layer=False)
    state = loop.init_state(params=params_np)
    it = iter(ShardedLMDataset(cfg, TRAIN_SMALL["batch"], TRAIN_SMALL["seq"],
                               seed=0, device=device))
    half = TRAIN_SMALL["steps"] // 2
    state = loop.run(state, it, half)
    state, info = loop.inject_failure(state, 0.5)
    # phase 17(a)'s two hosts lost at the second run's second step, so
    # that PARITY (parity_xor) runs too
    loop.loop_cfg.fail_schedule = [(2, kind, h)
                                   for _, kind, h in TRAIN_SCHEDULE]
    state = loop.run(state, it, TRAIN_SMALL["steps"] - half)
    hosts = [f for m in loop.metrics for f in m.get("failures", [])]
    check(len(hosts) == 1, f"{len(hosts)} host-loss recoveries, not 1")
    return {"losses": [m["loss"] for m in loop.metrics],
            "saved_iter": loop.controller.ckpt.saved_iter.cpu().tolist(),
            "tier_counts": info["tier_counts"],
            "host_tier_counts": hosts[0]["tier_counts"],
            "host_tier_sq": hosts[0]["tier_sq"],
            "applied_sq": info["applied_sq"]}


def phase_train_vs_cpu(device) -> dict:
    """Phase 17(c): reduced qwen2-1.5b and mamba2-370m (f32, 2 layers,
    the reference's stacked partition) from the same weights, batches and
    policy on the card and on the CPU: 6 steps, one
    ``inject_failure(0.5)`` and the two-host loss; losses within rtol
    1e-4, ``saved_iter`` and both losses' tier counts equal, PARITY used
    at zero perturbation."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.interop import to_numpy_tree
    from repro_torch.models import get_model

    out = {}
    for i, name in enumerate(("qwen2-1.5b", "mamba2-370m")):
        cfg = get_config(name, reduced=True)
        params_np = to_numpy_tree(get_model(cfg).init_params(
            torch.Generator().manual_seed(SEED + 18 + i), cfg, device="cpu"))
        gpu = _small_train(name, device, params_np)
        cpu = _small_train(name, "cpu", params_np)
        rel = max(abs(g - c) / abs(c) for g, c in zip(gpu["losses"],
                                                      cpu["losses"]))
        check(rel <= LOSS_RTOL, f"{name}: card losses {gpu['losses']}, CPU "
              f"{cpu['losses']}")
        check(gpu["saved_iter"] == cpu["saved_iter"]
              and gpu["tier_counts"] == cpu["tier_counts"]
              and gpu["host_tier_counts"] == cpu["host_tier_counts"],
              f"{name}: the card {gpu} and the CPU {cpu} differ")
        check(gpu["host_tier_counts"]["PARITY"] > 0
              and gpu["host_tier_sq"]["PARITY"] == 0.0
              and gpu["host_tier_sq"]["PEER_REPLICA"] == 0.0,
              f"{name}: the two-host loss {gpu['host_tier_counts']}, "
              f"{gpu['host_tier_sq']}")
        out[name] = {"losses": gpu["losses"], "max_rel_loss_diff": rel,
                     "tier_counts": gpu["tier_counts"],
                     "host_tier_counts": gpu["host_tier_counts"]}
    log(f"reduced trainers, card against CPU: {json.dumps(out)}")
    return out


def phase_train_mamba2(device) -> dict:
    """Phase 17(d): mamba2-370m at full width (d 1024, state 128, headdim
    64, bf16) with 4 of its 48 layers, arena-resident, 3 steps."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import ShardedLMDataset
    from repro_torch.training import ArenaTrainState

    cfg = dataclasses.replace(get_config("mamba2-370m"), n_layers=4)
    torch.cuda.reset_peak_memory_stats()
    loop = _train_loop(cfg, device)
    state = loop.init_state(
        torch.Generator(device=device).manual_seed(SEED + 20))
    check(isinstance(state, ArenaTrainState), "not arena-resident")
    ds = ShardedLMDataset(cfg, TRAIN["batch"], TRAIN["seq"], seed=0,
                          device=device)
    state = loop.run(state, iter(ds), 3)
    losses = [m["loss"] for m in loop.metrics]
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    out = {"losses": losses,
           "step_seconds": [m["seconds"] for m in loop.metrics],
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    log(f"mamba2-370m (4 layers) training, batch {TRAIN['batch']} x "
        f"{TRAIN['seq']}: {json.dumps(out)}")
    return out


def train_phases(device, launches: dict) -> dict:
    """Phase 17, its four parts; each frees what it built."""
    import torch
    t0 = time.perf_counter()
    out = {"qwen2_full": phase_train(device, launches)}
    gc.collect()
    torch.cuda.empty_cache()
    out["bit_equal"] = phase_train_bit_equal(device)
    out["card_vs_cpu"] = phase_train_vs_cpu(device)
    gc.collect()
    torch.cuda.empty_cache()
    out["mamba2_4_layers"] = phase_train_mamba2(device)
    gc.collect()
    torch.cuda.empty_cache()
    for name in TRAIN_KERNELS:
        check(launches["train"][name] > 0,
              f"{name} was not launched on the train path")
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 17: {out['seconds']:.1f} s")
    return out


TRAIN_KERNELS = ("arena_maintain", "arena_scatter", "masked_restore",
                 "block_dist", "parity_xor")


# ---------------------------------------------------------------------------
# Phase 18: the trainer with the disk store and async maintenance
# ---------------------------------------------------------------------------

STORE_POLICY = (0.125, 32)       # scar(0.125, 32): a 1/8 save every 4 steps
STORE_STEPS = 8
# 18(a)'s depth: 4 of qwen2-1.5b's 28 layers keep the whole script inside
# its time budget (phase 18 took 86-117 s with 18(a) at full depth, 54 s
# at 7 layers on a slow host)
STORE_LAYERS = 4
STORE_FREE_BYTES = 20e9          # the reckoning of 18(a)'s disk use
STORE_KERNELS_DISK = ("masked_restore", "block_dist", "scatter_save")


def _store_loop(cfg, device, *, asy: bool, store=None, fabric_kw=None,
                arena_state: bool = True, recorder=None,
                schedule=TRAIN_SCHEDULE):
    """``TrainLoop`` with adamw(3e-4), ``scar(0.125, 32)``, hosts 0 and 2
    lost at step 5 (``schedule``), and ``FabricConfig(async_maintain=asy,
    **fabric_kw)``."""
    from repro_torch.core.policy import CheckpointPolicy
    from repro_torch.fabric import FabricConfig
    from repro_torch.optim import adamw
    from repro_torch.training import TrainLoop, TrainLoopConfig
    return TrainLoop(cfg, adamw(3e-4), TrainLoopConfig(
        policy=CheckpointPolicy.scar(*STORE_POLICY),
        fabric=FabricConfig(async_maintain=asy, **(fabric_kw or {})),
        arena_state=arena_state, fail_schedule=schedule,
        recorder=recorder), store=store, device=device)


def _store_root() -> Path:
    """A fresh store directory under ``build/`` (never committed), its
    free space checked against 18(a)'s reckoning."""
    import shutil
    root = ROOT / "build" / "store_phase18"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    free = shutil.disk_usage(root).free
    check(free >= STORE_FREE_BYTES,
          f"{root} has {free / 1e9:.1f} GB free; phase 18 needs about "
          f"{STORE_FREE_BYTES / 1e9:.0f} GB (a 3.56 GB initial mirror, "
          f"0.45 GB of appends a save, the 10.71 GB parity mirror)")
    return root


def phase_store_async(device, launches: dict, root: Path) -> dict:
    """Phase 18(a): qwen2-1.5b at full width with ``STORE_LAYERS`` of its
    28 layers, async maintenance with a store, against the same run
    synchronous without a store (same weights and batches, deterministic
    algorithms on in both): losses, the checkpoint arena and the tier
    counts equal."""
    import dataclasses
    import torch
    from repro_torch.checkpoint_io import ShardedCheckpointStore
    from repro_torch.configs import get_config
    from repro_torch.core.arena import pack_arena
    from repro_torch.data import ShardedLMDataset
    from repro_torch.kernels import _build
    from repro_torch.telemetry import Recorder
    from repro_torch.training import ArenaTrainState

    cfg = dataclasses.replace(get_config("qwen2-1.5b"),
                              n_layers=STORE_LAYERS)
    runs = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for asy in (False, True):
            torch.cuda.reset_peak_memory_stats()
            rec = Recorder()
            store = (ShardedCheckpointStore(str(root / "a"), device=device)
                     if asy else None)
            loop = _store_loop(cfg, device, asy=asy, store=store,
                               recorder=rec)
            t0 = time.perf_counter()
            state = loop.init_state(
                torch.Generator(device=device).manual_seed(SEED + 30))
            torch.cuda.synchronize()
            init_s = time.perf_counter() - t0
            check(isinstance(state, ArenaTrainState), "not arena-resident")
            init_timings = dict(store.timings) if asy else {}
            ds = ShardedLMDataset(cfg, TRAIN["batch"], TRAIN["seq"], seed=0,
                                  device=device)
            # device memory after init and after each step (in use, peak)
            memory = [(torch.cuda.memory_allocated() / 1e9,
                       torch.cuda.max_memory_allocated() / 1e9)]
            if asy:
                _build.reset_launches()
            t0 = time.perf_counter()
            state = loop.run(state, iter(ds), STORE_STEPS,
                             on_step=lambda i, loss: memory.append((
                                 torch.cuda.memory_allocated() / 1e9,
                                 torch.cuda.max_memory_allocated() / 1e9)))
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            if asy:
                launches["store_async"] = dict(_build.LAUNCHES)
            ctl, fab = loop.controller, loop.controller.fabric
            fails = [(m["step"], f) for m in loop.metrics
                     for f in m.get("failures", [])]
            check(len(fails) == 1, f"{len(fails)} recoveries, not 1")
            step, info = fails[0]
            summ = loop.overhead_summary()
            clean = [m["seconds"] for m in loop.metrics
                     if "failures" not in m]
            out = {"losses": [m["loss"] for m in loop.metrics],
                   "ckpt": ctl._ckpt_arena.cpu(),
                   "tier_counts": info["tier_counts"],
                   "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                   "memory_gb_by_step": memory,
                   "step_seconds": [m["seconds"] for m in loop.metrics],
                   "median_step_seconds": statistics.median(clean),
                   "overhead_seconds": [m.get("overhead_seconds")
                                        for m in loop.metrics],
                   "overhead_p50": summ["overhead_seconds_p50"],
                   "overhead_p95": summ["overhead_seconds_p95"],
                   "overhead_phases_p50": {
                       k: v["p50"] for k, v in summ["phases"].items()},
                   "recovery_seconds": rec.tracer.durations("recovery")}
            if asy:
                saved = [m["step"] for m in loop.metrics
                         if m.get("checkpointed")]
                save_spans = {s.args["step"]: s.duration
                              for s in rec.tracer.spans if s.name == "save"}
                n_saves = ctl.stats["saves"]
                t = store.timings
                check(fab.stats["async_maintains"] == STORE_STEPS
                      and fab.side_stream_launches == STORE_STEPS,
                      f"{fab.stats['async_maintains']} async maintains, "
                      f"{fab.side_stream_launches} arena_maintain launches "
                      f"on the side stream; want {STORE_STEPS} of each")
                out.update({
                    "init_seconds": init_s, "run_seconds": run_s,
                    "initial_mirror": init_timings,
                    "tokens_per_second": TRAIN["batch"] * TRAIN["seq"]
                    / statistics.median(clean),
                    "fence_seconds": list(fab.fence_hist.samples),
                    "overlap_efficiency": summ["overlap_efficiency"],
                    "async_maintains": summ["async_maintains"],
                    "side_stream_launches": fab.side_stream_launches,
                    "saved_steps": saved,
                    "save_span_seconds": [save_spans.get(s)
                                          for s in saved],
                    "controller_save_seconds": ctl.stats["save_seconds"]
                    / max(n_saves, 1),
                    "per_save": {k: (t[k] - init_timings[k])
                                 / max(n_saves, 1) for k in t},
                    "bytes_mirrored": ctl.stats["bytes_mirrored"],
                    "disk_nbytes": store.disk_nbytes(),
                    "redundancy_nbytes": fab.redundancy_nbytes(store=store),
                    "recovery_step": step,
                    "lost_blocks": info["lost_blocks"],
                    "recovered_epoch": info["recovered_epoch"],
                    "staleness": info["staleness"],
                    "ledger_extra": rec.ledger.entries[-1].extra.get(
                        "staleness")})
                _check_recovery(info, "18(a) async with a store")
            runs[asy] = out
            layout = loop.arena_layout
            del loop, state, ctl, fab
            gc.collect()
            torch.cuda.empty_cache()
            if asy:
                # the mirror read back onto the card, packed: the
                # checkpoint arena, bit for bit
                t0 = time.perf_counter()
                back = pack_arena(store.read_all(), layout).cpu()
                out["read_all_seconds"] = time.perf_counter() - t0
                check(torch.equal(back, out["ckpt"]), "the store read back "
                      "differs from the checkpoint arena")
                del back
            del store
    finally:
        torch.use_deterministic_algorithms(False)
    s, a = runs[False], runs.pop(True)
    check(a["losses"] == s["losses"],
          f"async losses {a['losses']}, sync {s['losses']}")
    check(torch.equal(a.pop("ckpt"), s.pop("ckpt")),
          "the async checkpoint arena differs from the sync run's")
    check(a["tier_counts"] == s["tier_counts"],
          f"tier counts: async {a['tier_counts']}, sync {s['tier_counts']}")
    check(all(math.isfinite(x) for x in a["losses"]), f"{a['losses']}")
    a["sync"] = s      # the same run synchronous, without a store
    log(f"18(a) qwen2-1.5b ({STORE_LAYERS} layers), async maintenance with "
        f"a store, batch {TRAIN['batch']} x {TRAIN['seq']}, {STORE_STEPS} "
        f"steps: "
        f"{json.dumps(a)}")
    return a


def phase_store_disk(device, launches: dict, root: Path) -> dict:
    """Phase 18(b): qwen2-1.5b with 4 layers, ``FabricConfig(
    replicate=False, parity=False)`` and a store, on the PyTree path: 4
    steps (a save at step 4), then hosts 0 and 2 lost. Blocks whose
    running-checkpoint home died come back from DISK, equal to the running
    checkpoint, in one masked_restore launch; the store read through the
    CPU reader equals the card's checkpoint."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.checkpoint_io import ShardedCheckpointStore
    from repro_torch.configs import get_config
    from repro_torch.data import ShardedLMDataset
    from repro_torch.kernels import _build
    from repro_torch.utils.tree import tree_leaves

    cfg = dataclasses.replace(get_config("qwen2-1.5b"), n_layers=4)
    store = ShardedCheckpointStore(str(root / "b"), device=device)
    loop = _store_loop(cfg, device, asy=False, store=store,
                       fabric_kw=dict(replicate=False, parity=False),
                       arena_state=False, schedule=None)
    state = loop.init_state(
        torch.Generator(device=device).manual_seed(SEED + 31))
    reads = []
    read_blocks = store.read_blocks

    def spy(mask):
        reads.append((_build.LAUNCHES["masked_restore"],
                      np.asarray(mask, bool).copy()))
        return read_blocks(mask)

    store.read_blocks = spy
    ds = ShardedLMDataset(cfg, TRAIN["batch"], TRAIN["seq"], seed=0,
                          device=device)
    ctl = loop.controller
    _build.reset_launches()
    t0 = time.perf_counter()
    state = loop.run(state, iter(ds), 4)
    check(ctl.stats["saves"] == 1, f"{ctl.stats['saves']} saves, not 1")
    live = state.params
    t1 = time.perf_counter()
    rec, info = ctl.on_domain_events(live, [("host", 0), ("host", 2)],
                                     step=4)
    torch.cuda.synchronize()
    recovery_s = time.perf_counter() - t1
    run_s = time.perf_counter() - t0
    launches["store_disk"] = dict(_build.LAUNCHES)
    tiers = info["tier_counts"]
    check(tiers["DISK"] > 0, f"no DISK blocks: {tiers}")
    check(len(reads) == 1, f"{len(reads)} disk reads, not 1")
    at_read, disk = reads[0]
    check(int(disk.sum()) == tiers["DISK"], "the disk read's mask is not "
          "the DISK tier's")
    disk_launches = launches["store_disk"]["masked_restore"] - at_read
    check(disk_launches == 1, f"the DISK restore took {disk_launches} "
          f"masked_restore launches, not 1")
    br = ctl.partition.block_rows
    for leaf, x, ck in zip(ctl.partition.leaves, tree_leaves(rec),
                           tree_leaves(ctl.ckpt.values)):
        for b in np.nonzero(disk[leaf.offset:leaf.offset
                                 + leaf.n_blocks])[0]:
            rows = slice(int(b) * br, (int(b) + 1) * br)
            check(torch.equal(x.reshape(max(leaf.rows, 1), -1)[rows],
                              ck.reshape(max(leaf.rows, 1), -1)[rows]),
                  f"DISK block {leaf.offset + int(b)} of {leaf.name} "
                  f"differs from the running checkpoint")
    back = store.reader("cpu").read_all()
    check(all(torch.equal(x.cpu(), y) for x, y in
              zip(tree_leaves(ctl.ckpt.values), tree_leaves(back))),
          "the store read on the CPU differs from the card's checkpoint")
    out = {"run_seconds": run_s, "recovery_seconds": recovery_s,
           "tier_counts": tiers, "lost_blocks": info["lost_blocks"],
           "tier_sq": info["tier_sq"],
           "disk_masked_restore_launches": disk_launches,
           "disk_nbytes": store.disk_nbytes(),
           "losses": [m["loss"] for m in loop.metrics]}
    log(f"18(b) qwen2-1.5b (4 layers), DISK tier: {json.dumps(out)}")
    return out


def phase_store_example(device, root: Path) -> dict:
    """Phase 18(c): the ported ``train_lm_with_failures`` at ``--tiny`` on
    the card, arena-resident and ``--pytree`` (deterministic algorithms
    on): bit-equal losses, failures included."""
    import torch
    from repro_torch.examples import train_lm_with_failures as example

    runs = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for flag in ((), ("--pytree",)):
            args = example.parse_args(["--tiny", "--steps", "8",
                                       "--fail-prob", "0.3",
                                       "--device", str(device), *flag])
            got = example.train(args, str(root / ("c" + "".join(flag))),
                                verbose=False)
            runs[bool(flag)] = {k: got[k] for k in ("losses", "failures",
                                                    "saves", "arena_state")}
            del got
    finally:
        torch.use_deterministic_algorithms(False)
    a, t = runs[False], runs[True]
    check(a["arena_state"] and not t["arena_state"], "wrong state forms")
    check(a["losses"] == t["losses"] and a["failures"] == t["failures"],
          f"the example's arena run {a} and PyTree run {t} differ")
    log(f"18(c) the ported example, --tiny: {json.dumps(a)}")
    return a


def store_phases(device, launches: dict) -> dict:
    """Phase 18, its three parts, in a store directory removed at the end
    (also when a check fails)."""
    import shutil
    import torch
    t0 = time.perf_counter()
    root = _store_root()
    try:
        out = {"async_store": phase_store_async(device, launches, root)}
        gc.collect()
        torch.cuda.empty_cache()
        out["disk_tier"] = phase_store_disk(device, launches, root)
        gc.collect()
        torch.cuda.empty_cache()
        out["example"] = phase_store_example(device, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for name in TRAIN_KERNELS:
        check(launches["store_async"][name] > 0,
              f"{name} was not launched on the store_async path")
    for name in STORE_KERNELS_DISK:
        check(launches["store_disk"][name] > 0,
              f"{name} was not launched on the store_disk path")
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 18: {out['seconds']:.1f} s")
    return out


def store_only(device, card: str) -> int:
    """``--store``: phase 18 alone. Its last line says that it is this
    partial run, never the full run's ``{"ok": true, ...}``."""
    import torch
    launches = {}
    out = store_phases(device, launches)
    log(json.dumps({"store": out, "launches": {
        k: launches[k] for k in ("store_async", "store_disk")}}))
    log(card)
    log(json.dumps({"store_only": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def train_only(device, card: str) -> int:
    """``--train``: phase 17 alone. Its last line says that it is this
    partial run, never the full run's ``{"ok": true, ...}``."""
    import torch
    launches = {}
    out = train_phases(device, launches)
    log(json.dumps({"train": out, "launches": launches["train"]}))
    log(card)
    log(json.dumps({"train_only": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# ---------------------------------------------------------------------------
# phases 21-22: the hybrid (zamba2-1.2b) and encoder-decoder
# (whisper-medium) families trained at full width
# ---------------------------------------------------------------------------

# 448 tokens: whisper's published decoder context; 1,500 frames a sequence.
# Depths cut to the script's time budget: whisper-medium's decoder at 12 of
# 24 layers, zamba2-1.2b at 7 of 38 Mamba2 layers (two segments: the shared
# block runs twice and its gradient sums both uses)
TRAIN_WHISPER = dict(batch=4, seq=448, steps=8, layers=12)
TRAIN_ZAMBA2 = dict(TRAIN, layers=7)


def phase_zamba2_train(device, launches: dict) -> dict:
    """Phase 21: zamba2-1.2b at full width (7 of its 38 Mamba2 layers,
    the shared block twice, bf16, per-layer leaves) trained as phase 17(a)
    trains qwen2-1.5b; ``launches["zamba2_train"]``."""
    out = _train_full("zamba2-1.2b", device, launches, "zamba2_train",
                      TRAIN_ZAMBA2, seed=21)
    log(f"phase 21: zamba2-1.2b training, batch {TRAIN['batch']} x "
        f"{TRAIN['seq']}, {TRAIN['steps']} steps: {json.dumps(out)}")
    return out


def phase_whisper_train(device, launches: dict) -> dict:
    """Phase 22: whisper-medium at full width (24 encoder and 12 of its 24
    decoder layers, the untied head, bf16, per-layer leaves) trained as
    phase 17(a) trains qwen2-1.5b, on batches of 4 sequences of 1,500
    frames and 448 tokens; ``launches["whisper_train"]``."""
    out = _train_full("whisper-medium", device, launches, "whisper_train",
                      TRAIN_WHISPER, seed=22)
    log(f"phase 22: whisper-medium training, batch {TRAIN_WHISPER['batch']}"
        f" x (1500 frames, {TRAIN_WHISPER['seq']} tokens), "
        f"{TRAIN_WHISPER['steps']} steps: {json.dumps(out)}")
    return out


def train_family_phases(device, launches: dict) -> dict:
    """Phases 21 and 22; each frees what it built."""
    import torch
    out = {}
    for key, phase in (("zamba2_train", phase_zamba2_train),
                       ("whisper_train", phase_whisper_train)):
        t0 = time.perf_counter()
        out[key] = phase(device, launches)
        out[key]["seconds"] = time.perf_counter() - t0
        log(f"{key}: {out[key]['seconds']:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()
    return out


def train_families_only(device, card: str) -> int:
    """``--train-families``: phases 21 and 22 alone. Its last line says
    that it is this partial run, never the full run's ``{"ok": true,
    ...}``."""
    import torch
    launches = {}
    out = train_family_phases(device, launches)
    log(json.dumps({"train_families": out, "launches": launches}))
    log(card)
    log(json.dumps({"train_families_only": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# ---------------------------------------------------------------------------
# phase 23: the ported examples on the card
# ---------------------------------------------------------------------------

SERVE_EXAMPLE_ARCHS = ("yi-9b", "mamba2-370m", "zamba2-1.2b",
                       "whisper-medium", "qwen3-moe-235b-a22b",
                       "llama4-maverick-400b-a17b", "internvl2-76b")
TINY_TRAIN_ARCHS = ("zamba2-1.2b", "whisper-medium", "qwen3-moe-235b-a22b",
                    "internvl2-76b")
# every kernel but fused_maintain (the per-leaf fabric, which no example
# takes) launches on the examples' path
EXAMPLE_KERNELS = ("block_dist", "scatter_save", "masked_restore",
                   "arena_maintain", "arena_scatter", "parity_xor",
                   "gf256_mac", "sw_attention", "ssd_intra")


def _run_examples(device, root: Path, inputs: dict) -> dict:
    """Each ported example once on ``device``, at its default size
    (``train_lm_with_failures`` at ``--tiny`` for the hybrid,
    encoder-decoder, MoE and VLM families, 8 steps, ``--fail-prob 0.3``);
    the LM examples from ``inputs``' numpy weights and prompts, so the
    card and the CPU see the same ones."""
    from repro_torch.examples import (adaptive_checkpoint_policy,
                                      correlated_failures,
                                      priority_vs_random_checkpoints,
                                      quickstart, serve_with_recovery,
                                      train_lm_with_failures)
    dev = str(device)
    out = {"quickstart": quickstart.run(device, verbose=False),
           "priority": priority_vs_random_checkpoints.run(device,
                                                          verbose=False),
           "adaptive": adaptive_checkpoint_policy.run(device, verbose=False),
           "correlated": correlated_failures.run(device, verbose=False)}
    for arch in SERVE_EXAMPLE_ARCHS:
        params, batch = inputs["serve", arch]
        got = serve_with_recovery.run(serve_with_recovery.parse_args(
            ["--arch", arch, "--device", dev]), params, batch, verbose=False)
        out["serve", arch] = {
            "tokens": got["tokens_before"].cpu().tolist(),
            "identical": got["identical"],
            "lost_blocks": got["info"]["lost_blocks"]}
    for arch in TINY_TRAIN_ARCHS:
        args = train_lm_with_failures.parse_args(
            ["--tiny", "--arch", arch, "--steps", "8", "--fail-prob", "0.3",
             "--device", dev])
        got = train_lm_with_failures.train(
            args, str(root / f"{arch}_{device.type}"), params=inputs["train",
                                                                   arch],
            verbose=False)
        out["train", arch] = {
            "losses": got["losses"], "arena_state": got["arena_state"],
            "failures": [(m["step"], m["failure"]["tier_counts"])
                         for m in got["loop"].metrics if "failure" in m]}
        del got
    return out


def _examples_inputs() -> dict:
    """The LM examples' weights and prompts, drawn once on the CPU and
    carried as numpy (the card's and the CPU's generators differ)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.examples.train_lm_with_failures import model_config
    from repro_torch.interop import to_numpy_tree
    from repro_torch.models import get_model
    inputs = {}
    for arch in SERVE_EXAMPLE_ARCHS:
        cfg = get_config(arch, reduced=True)
        inputs["serve", arch] = (
            to_numpy_tree(get_model(cfg).init_params(
                torch.Generator().manual_seed(SEED), cfg, device="cpu")),
            to_numpy_tree(lm_batch(torch.Generator().manual_seed(SEED + 1),
                                   cfg, 4, 32, device="cpu")))
    for arch in TINY_TRAIN_ARCHS:
        cfg = model_config(arch, True)[0]
        inputs["train", arch] = to_numpy_tree(get_model(cfg).init_params(
            torch.Generator().manual_seed(SEED + 23), cfg, device="cpu"))
    return inputs


def _costs_near(a, b) -> bool:
    """Iteration costs within the ±1 that phase 4 allows the card."""
    return abs(a - b) <= 1


def _check_examples(gpu: dict, cpu: dict) -> dict:
    """Each example's card run against its CPU run: tier counts, lost
    blocks, fallbacks, the advisor's choices and tokens equal; iteration
    costs within ±1; losses and the fitted contraction within rtol
    1e-4."""
    import numpy as np

    def close(a, b, what):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        check(a.shape == b.shape and bool(np.all(
            np.abs(a - b) <= LOSS_RTOL * np.abs(b))),
            f"{what}: card {a.tolist()}, CPU {b.tolist()}")

    g, c = gpu["quickstart"], cpu["quickstart"]
    check(g["scar"]["recovery"]["tier_counts"]
          == c["scar"]["recovery"]["tier_counts"],
          "quickstart: tier counts differ between the card and the CPU")
    for run in ("scar", "traditional"):
        check(_costs_near(g[run]["iteration_cost"], c[run]["iteration_cost"]),
              f"quickstart {run}: iteration cost {g[run]['iteration_cost']} "
              f"on the card, {c[run]['iteration_cost']} on the CPU")
        close(g[run]["losses"], c[run]["losses"], f"quickstart {run} losses")
    close(g["clean_losses"], c["clean_losses"], "quickstart clean losses")
    for (name, r, on_card), (_, _, on_cpu) in zip(gpu["priority"],
                                                   cpu["priority"]):
        check(all(_costs_near(a, b) for a, b in zip(on_card, on_cpu)),
              f"priority_vs_random {name} r={r}: costs {on_card} on the "
              f"card, {on_cpu} on the CPU")
    g, c = gpu["adaptive"], cpu["adaptive"]
    close(g["c"], c["c"], "adaptive_checkpoint_policy's contraction")
    check([a[1:4] for a in g["advice"]] == [a[1:4] for a in c["advice"]],
          f"adaptive_checkpoint_policy: advice {g['advice']} on the card, "
          f"{c['advice']} on the CPU")
    g, c = gpu["correlated"], cpu["correlated"]
    check(g["trace_kinds"] == c["trace_kinds"], "correlated: MTBF traces")
    for a, b in zip(g["host_loss"], c["host_loss"]):
        check(a[3] == b[3] and abs(a[2] - b[2]) <= 1,
              f"correlated host loss {a} on the card, {b} on the CPU")
    for a, b in zip(g["soak"], c["soak"]):
        check(a[3] == b[3] and _costs_near(a[1], b[1]),
              f"correlated soak {a} on the card, {b} on the CPU")
    for a, b in zip(g["multi_erasure"], c["multi_erasure"]):
        check(a[3:] == b[3:] and _costs_near(a[1], b[1]),
              f"correlated multi-erasure {a} on the card, {b} on the CPU")
    for arch in SERVE_EXAMPLE_ARCHS:
        a, b = gpu["serve", arch], cpu["serve", arch]
        check(a == b and a["identical"], f"serve_with_recovery {arch}: "
              f"card {a}, CPU {b}")
    for arch in TINY_TRAIN_ARCHS:
        a, b = gpu["train", arch], cpu["train", arch]
        close(a["losses"], b["losses"], f"train_lm_with_failures {arch}")
        check(a["arena_state"] and a["failures"] == b["failures"]
              and len(a["failures"]) > 0,
              f"train_lm_with_failures {arch}: failures {a['failures']} on "
              f"the card, {b['failures']} on the CPU")
    return {"quickstart_iteration_cost": gpu["quickstart"]["scar"][
                "iteration_cost"],
            "traditional_iteration_cost": gpu["quickstart"]["traditional"][
                "iteration_cost"],
            "priority_mean_costs": [[n, r, float(np.mean(k))]
                                    for n, r, k in gpu["priority"]],
            "advice": gpu["adaptive"]["advice"],
            "multi_erasure": gpu["correlated"]["multi_erasure"],
            "serve_tokens": {a: gpu["serve", a]["tokens"][0]
                             for a in SERVE_EXAMPLE_ARCHS},
            "train_losses": {a: gpu["train", a]["losses"]
                             for a in TINY_TRAIN_ARCHS},
            "train_failures": {a: gpu["train", a]["failures"]
                               for a in TINY_TRAIN_ARCHS}}


def _examples_cpu() -> dict:
    """Phase 23's CPU runs (:func:`_run_examples` on the CPU, on
    :func:`_examples_inputs`), their stores in a directory of their own
    under ``build/``, removed at the end; with their seconds."""
    import shutil
    import torch
    root = ROOT / "build" / f"examples_phase23_cpu_{os.getpid()}"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    try:
        t0 = time.perf_counter()
        runs = _run_examples(torch.device("cpu"), root, _examples_inputs())
        return {"runs": runs, "seconds": time.perf_counter() - t0}
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase_examples(device, launches: dict, cpu=None) -> dict:
    """Phase 23: the six ported examples on the card, each held against
    the same call on the CPU (``cpu``: :func:`_examples_cpu`'s result, run
    beforehand in another process; else run here after the card's);
    ``launches["examples"]`` gets the card runs' counts. Stores go to a
    directory under ``build/``, removed at the end."""
    import shutil
    from repro_torch.kernels import _build
    root = ROOT / "build" / "examples_phase23"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    try:
        inputs = _examples_inputs()
        _build.reset_launches()
        t0 = time.perf_counter()
        gpu = _run_examples(device, root, inputs)
        card_s = time.perf_counter() - t0
        launches["examples"] = dict(_build.LAUNCHES)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if cpu is None:
        cpu = _examples_cpu()
    cpu, cpu_s = cpu["runs"], cpu["seconds"]
    out = _check_examples(gpu, cpu)
    for kernel in EXAMPLE_KERNELS:
        check(launches["examples"][kernel] > 0,
              f"{kernel} was not launched on the examples path")
    out.update({"card_seconds": card_s, "cpu_seconds": cpu_s})
    log(f"phase 23: the six examples on the card against the CPU: "
        f"{json.dumps(out)}")
    return out


def examples_only(device, card: str) -> int:
    """``--examples``: phase 23 alone. Its last line says that it is this
    partial run, never the full run's ``{"ok": true, ...}``."""
    import torch
    launches = {}
    out = phase_examples(device, launches)
    log(json.dumps({"examples": out, "launches": launches["examples"]}))
    log(card)
    log(json.dumps({"examples_only": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# ---------------------------------------------------------------------------
# phases 27-28: the MoE (qwen3-moe-235b-a22b, llama4-maverick-400b-a17b) and
# VLM (internvl2-76b) families trained
# ---------------------------------------------------------------------------

# phase 27: 1,024 stub patches and 2,048 tokens a sequence, run as the
# config's 4 microbatches; one of the 80 layers (2.98 G values)
TRAIN_INTERNVL2 = dict(batch=4, seq=2048, steps=6, layers=1)
# phase 28(a): qwen3-moe's MoE layer on (4, 2048) tokens
MOE_LAYER = dict(batch=4, seq=2048, runs=3)
MOE_GRAD_RTOL = 1e-3
MOE_VLM_ARCHS = ("qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b",
                 "internvl2-76b")


def phase_internvl2_train(device, launches: dict) -> dict:
    """Phase 27: internvl2-76b at full width (d 8192, GQA 64/8, d_ff 28672,
    the projector from 3200, the untied head, bf16) with 1 of its 80
    layers, per-layer leaves (``wo`` 2-D), trained as phase 17(a) trains
    qwen2-1.5b on batches of 4 x (1,024 patches + 2,048 tokens) run as 4
    microbatches; ``launches["internvl2_train"]``."""
    out = _train_full("internvl2-76b", device, launches, "internvl2_train",
                      TRAIN_INTERNVL2, seed=27)
    check(out["tier_counts"]["PEER_REPLICA"] > 0
          and out["tier_counts"]["PARITY"] > 0,
          f"internvl2-76b: the two-host loss took {out['tier_counts']}")
    log(f"phase 27: internvl2-76b training ({TRAIN_INTERNVL2['layers']} of "
        f"80 layers), batch {TRAIN_INTERNVL2['batch']} x (1024 patches + "
        f"{TRAIN_INTERNVL2['seq']} tokens), {TRAIN_INTERNVL2['steps']} "
        f"steps: {json.dumps(out)}")
    return out


def _moe_grads(x, dy, p, cfg):
    """One forward and backward of ``moe_block``: the gradients of ``<out,
    dy> + 0.01 lb + 0.001 zl`` with respect to x, the router and the three
    expert stacks (3-D or held 2-D, ``p``'s form), and the aux losses."""
    import torch
    from repro_torch.models import layers as L
    q = {k: p[k].detach().requires_grad_(True)
         for k in ("router",) + L.EXPERT_KEYS}
    xr = x.detach().requires_grad_(True)
    with torch.enable_grad():
        out, (lb, zl) = L.moe_block(xr, q, cfg)
        loss = (out.float() * dy.float()).sum() + 0.01 * lb + 0.001 * zl
        grads = torch.autograd.grad(
            loss, [xr] + [q[k] for k in ("router",) + L.EXPERT_KEYS])
    return list(grads), (lb.detach(), zl.detach())


def phase_moe_layer(device) -> dict:
    """Phase 28(a): qwen3-moe-235b-a22b's MoE layer at full width (d 4096,
    128 experts, top-8 of d_ff 1536, bf16, the router f32) on (4, 2048)
    tokens, forward and backward, on the trainer's 2-D expert leaves
    (``split_layers``' ``(E·D, F)``/``(E·F, D)``, viewed as the stacks),
    held against the stacked ``(E, D, F)`` form (3-D views of the same
    weights) on the same inputs: finite gradients, the x, router and
    expert gradients in f32 within relative L2 1e-3, the aux losses
    equal. Reported: the seconds of one forward and backward (median of 3
    after a warm-up) and its peak with only the layer resident."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L

    cfg = get_config("qwen3-moe-235b-a22b")
    gen = torch.Generator(device=device).manual_seed(SEED + 28)
    stacked = L.init_moe(gen, cfg, torch.bfloat16, device)
    shape = (MOE_LAYER["batch"], MOE_LAYER["seq"], cfg.d_model)
    x = torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)
    dy = torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)
    split = L._own_leaves(stacked, False)
    check(all(split[k].dim() == 2 for k in L.EXPERT_KEYS),
          "qwen3-moe layer: the expert stacks are not held 2-D")
    del stacked
    gc.collect()
    torch.cuda.empty_cache()

    secs = []
    for _ in range(MOE_LAYER["runs"] + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = _moe_grads(x, dy, split, cfg)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        del got
    out = {"experts": cfg.n_experts, "top_k": cfg.top_k,
           "tokens": shape[0] * shape[1],
           "capacity": L.moe_capacity(shape[0] * shape[1], cfg),
           "fwd_bwd_seconds": statistics.median(secs[1:])}
    # the peak with only the layer's own weights and inputs resident
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    gs, aux_s = _moe_grads(x, dy, split, cfg)
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["peak_above_inputs_gb"] = (torch.cuda.max_memory_allocated()
                                   - base) / 1e9
    # the stacked (E, D, F) / (E, F, D) leaves: views of the same weights
    E = cfg.n_experts
    stacked = {"router": split["router"],
               **{k: split[k].view(E, -1, split[k].shape[-1])
                  for k in L.EXPERT_KEYS}}
    gb, aux_b = _moe_grads(x, dy, stacked, cfg)
    check(all(bool(torch.isfinite(g).all()) for g in gs),
          "qwen3-moe layer: non-finite gradients on the 2-D leaves")
    check(torch.equal(aux_s[0], aux_b[0]) and torch.equal(aux_s[1], aux_b[1]),
          f"qwen3-moe layer: aux losses {aux_s} on 2-D leaves, {aux_b} "
          f"stacked")
    worst = {k: _rel_l2(g.reshape(b.shape), b) for k, g, b in zip(
        ("x", "router") + L.EXPERT_KEYS, gs, gb)}
    out["grad_rel_l2"] = worst
    out["lb_loss"], out["z_loss"] = float(aux_s[0]), float(aux_s[1])
    check(all(v <= MOE_GRAD_RTOL for v in worst.values()),
          f"qwen3-moe layer: 2-D against stacked gradients {worst}")
    log(f"phase 28(a): qwen3-moe-235b-a22b MoE layer forward and backward "
        f"on {shape[:2]} tokens: {json.dumps(out)}")
    return out


def phase_moe_train_loss(device) -> dict:
    """Phase 28(a), the trainer's loss: ``loss_and_grad`` through
    ``train_loss`` (embedding, ``layer_walk`` under remat, the MoE block's
    aux losses over ``n_layers``, the chunked f32 head) for
    qwen3-moe-235b-a22b at full width with 1 of its 94 layers (bf16,
    3.73 G values) on (4, 2048) tokens, on the reference's stacked tree
    and then on the trainer's per-layer leaves from the same weights:
    both losses finite and within rtol 1e-4 of each other, every gradient
    finite, each leaf's within relative L2 1e-3 in f32 (the embedding's
    gradient may add its rows in another order), the router's and every expert
    stack's nonzero. The whole model does not fit the card (ROADMAP item
    32)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.models import layers as L
    from repro_torch.training.step import loss_and_grad
    from repro_torch.utils.tree import tree_leaves

    cfg = dataclasses.replace(get_config("qwen3-moe-235b-a22b"), n_layers=1)
    ops = get_model(cfg)
    gen = torch.Generator(device=device).manual_seed(SEED + 30)
    torch.cuda.reset_peak_memory_stats()
    params = ops.init_params(gen, cfg, device=device)
    toks = torch.randint(0, cfg.vocab, (MOE_LAYER["batch"],
                                        MOE_LAYER["seq"] + 1),
                         generator=gen, device=device, dtype=torch.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    out = {"params": sum(x.numel() for x in tree_leaves(params))}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    l0, g0 = loss_and_grad(ops, cfg, params, batch)
    torch.cuda.synchronize()
    out["stacked_first_call_seconds"] = time.perf_counter() - t0
    (key, _), = ops.stacked_layers
    split = L.split_layers(params, ops.stacked_layers)
    del params
    gc.collect()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    l1, g1 = loss_and_grad(ops, cfg, split, batch)
    torch.cuda.synchronize()
    out["loss_and_grad_seconds"] = time.perf_counter() - t0
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["loss"], out["split_loss"] = float(l0), float(l1)
    check(math.isfinite(out["loss"]) and math.isfinite(out["split_loss"])
          and abs(out["split_loss"] - out["loss"])
          <= LOSS_RTOL * abs(out["loss"]),
          f"qwen3-moe train_loss: {out['loss']} stacked, "
          f"{out['split_loss']} split")
    del split
    worst, names = 0.0, []
    for a, b in zip(tree_leaves(g0[key]), tree_leaves(g1[key][0])):
        check(bool(torch.isfinite(b).all()), "qwen3-moe train_loss: "
              "non-finite gradients")
        worst = max(worst, _rel_l2(b, a[0].reshape(b.shape)))
    for k in set(g0) - {key}:
        for a, b in zip(tree_leaves(g0[k]), tree_leaves(g1[k])):
            check(bool(torch.isfinite(b).all()), "qwen3-moe train_loss: "
                  "non-finite gradients")
            worst = max(worst, _rel_l2(b, a))
    out["grad_rel_l2"] = worst
    moe = g1[key][0]["moe"]
    for k in ("router",) + L.EXPERT_KEYS:
        if float(moe[k].float().abs().sum()) == 0.0:
            names.append(k)
    check(worst <= MOE_GRAD_RTOL and not names,
          f"qwen3-moe train_loss: gradients split against stacked {worst}, "
          f"zero: {names}")
    log(f"phase 28(a): qwen3-moe-235b-a22b train_loss and its gradient, 1 "
        f"of 94 layers at full width, {MOE_LAYER['batch']} x "
        f"{MOE_LAYER['seq']} tokens: {json.dumps(out)}")
    return out


def phase_moe_vlm_reduced(device, launches: dict) -> dict:
    """Phase 28(b): the three families at their reduced configs (f32, 2
    layers, the reference's stacked partition) on the card and on the CPU
    from the same weights and batches, as phase 17(c): losses within rtol
    1e-4, ``saved_iter`` and both losses' tier counts equal, PARITY used
    at zero perturbation; then arena = PyTree bit for bit on the card
    (per-layer leaves, deterministic algorithms), for each config and for
    llama4's in bf16 with its bf16 ``opt_moment_dtype`` and 2
    microbatches; ``launches["moe_train"]`` counts the card's runs."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.interop import to_numpy_tree
    from repro_torch.kernels import _build
    from repro_torch.models import get_model

    out = {}
    _build.reset_launches()
    for i, name in enumerate(MOE_VLM_ARCHS):
        cfg = get_config(name, reduced=True)
        params_np = to_numpy_tree(get_model(cfg).init_params(
            torch.Generator().manual_seed(SEED + 28 + i), cfg, device="cpu"))
        gpu = _small_train(name, device, params_np)
        cpu = _small_train(name, "cpu", params_np)
        rel = max(abs(g - c) / abs(c) for g, c in zip(gpu["losses"],
                                                      cpu["losses"]))
        check(rel <= LOSS_RTOL, f"{name}: card losses {gpu['losses']}, CPU "
              f"{cpu['losses']}")
        check(gpu["saved_iter"] == cpu["saved_iter"]
              and gpu["tier_counts"] == cpu["tier_counts"]
              and gpu["host_tier_counts"] == cpu["host_tier_counts"],
              f"{name}: the card {gpu} and the CPU {cpu} differ")
        check(gpu["host_tier_counts"]["PARITY"] > 0
              and gpu["host_tier_sq"]["PARITY"] == 0.0
              and gpu["host_tier_sq"]["PEER_REPLICA"] == 0.0,
              f"{name}: the two-host loss {gpu['host_tier_counts']}, "
              f"{gpu['host_tier_sq']}")
        out[name] = {"losses": gpu["losses"], "max_rel_loss_diff": rel,
                     "host_tier_counts": gpu["host_tier_counts"],
                     "bit_equal": _arena_against_pytree(
                         cfg, device, TRAIN_SMALL, SEED + 29, name)}
    llama4 = get_config(MOE_VLM_ARCHS[1], reduced=True)
    check(llama4.opt_moment_dtype == "bfloat16", "llama4's moments")
    out["llama4_bf16_microbatch_2"] = _arena_against_pytree(
        dataclasses.replace(llama4, dtype="bfloat16", microbatch=2), device,
        TRAIN_SMALL, SEED + 29, "llama4 (bf16, 2 microbatches)")
    launches["moe_train"] = dict(_build.LAUNCHES)
    for kernel in TRAIN_KERNELS:
        check(launches["moe_train"][kernel] > 0,
              f"{kernel} was not launched on the moe_train path")
    log(f"phase 28(b): the MoE and VLM families' reduced trainers, card "
        f"against CPU and arena against PyTree: {json.dumps(out)}")
    return out


def train_moe_vlm_phases(device, launches: dict) -> dict:
    """Phases 27, 28(a) (the MoE layer, then the trainer's loss) and
    28(b); each frees what it built."""
    import torch
    out = {}
    for key, phase in (("internvl2_train",
                        lambda: phase_internvl2_train(device, launches)),
                       ("moe_layer", lambda: phase_moe_layer(device)),
                       ("moe_train_loss",
                        lambda: phase_moe_train_loss(device)),
                       ("moe_vlm_reduced",
                        lambda: phase_moe_vlm_reduced(device, launches))):
        t0 = time.perf_counter()
        out[key] = phase()
        out[key]["seconds"] = time.perf_counter() - t0
        log(f"{key}: {out[key]['seconds']:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()
    return out


def train_moe_vlm_only(device, card: str) -> int:
    """``--train-moe-vlm``: phases 27 and 28 alone. Its last line says
    that it is this partial run, never the full run's ``{"ok": true,
    ...}``."""
    import torch
    launches = {}
    out = train_moe_vlm_phases(device, launches)
    log(json.dumps({"train_moe_vlm": out, "launches": launches}))
    log(card)
    log(json.dumps({"train_moe_vlm_only": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# ---------------------------------------------------------------------------
# phase 29: the perf variants (the int8 KV cache and the triangle prefill)
# on command-r-plus-104b at full width and a 32k prompt
# ---------------------------------------------------------------------------

# full width, 4 of 64 layers (12.58 G values, 25.17 GB in bf16), a
# 32,768-token prompt, batch 1, 16 new tokens
PERF_VARIANTS = dict(layers=4, seq=32768, new=16)
# 29(c): decode over a filled 32,768-position cache, bf16 against int8. The
# bf16 decode repeats the cache over G = 12 and pads it to whole chunks:
# about 6.5 GB a tensor at batch 8 (four alive a layer, 26 GB), 52 GB at
# batch 16, which with the 25.2 GB model and the 8.6 GB cache does not fit
# an 80 GB card
PERF_DECODE = dict(batch=8, steps=8)
# 29(d): the reduced configs with both flags, card against CPU
PERF_REDUCED = ("yi-9b", "granite-8b", "command-r-plus-104b",
                "qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b",
                "internvl2-76b")
# the reference's own bound on the int8 decode's next-token probabilities
# (tests/test_perf_variants.py)
PROB_TOL = 0.05
# the int8 decode's logits against the bf16 cache's, relative L2: a bound
# between the sound decode's readings (0.0173 at 29(b), 0.0220 at 29(c) on
# an H100) and a decode's with its scales left out (1.33, 1.41). A token
# not written reads 0.0198 and 0.0243, too close to the sound readings for
# any bound: the new slots are held bit for bit instead (_hold_new_slot)
LOGITS_L2_TOL = 0.1


def _cache_gb(cache) -> float:
    return sum(x.numel() * x.element_size() for k, x in cache.items()
               if k in ("k", "v", "k_scale", "v_scale")) / 1e9


def _probs(logits):
    import torch
    return torch.softmax(logits[:, -1].float(), dim=-1)


def _prob_gap(a, b) -> float:
    return float((_probs(a) - _probs(b)).abs().max())


def _perf_model(device):
    """command-r-plus-104b at full width, ``PERF_VARIANTS["layers"]`` of
    its layers, bf16, random weights from a seed: (cfg, its kv_quant +
    triangle_prefill twin, params)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    import torch
    cfg = dataclasses.replace(get_config("command-r-plus-104b"),
                              n_layers=PERF_VARIANTS["layers"])
    cfg_on = dataclasses.replace(cfg, kv_quant=True, triangle_prefill=True)
    params = get_model(cfg).init_params(torch.Generator(
        device=device).manual_seed(SEED + 290), cfg, device=device)
    return cfg, cfg_on, params


def _layer0_qkv(params, batch, cfg):
    """Layer 0's q, k, v in the prefill of ``batch`` (bf16)."""
    import torch
    from repro_torch.models import layers as L
    from repro_torch.models.transformer import _embed_batch
    x = _embed_batch(params, batch, cfg)
    lp = L.layer_params(params, 0)
    pos = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    return (*L.qkv_project(L.rms_norm(x, lp["attn_norm"]), lp["attn"], cfg,
                           pos), pos)


def _hold_triangle(params, batch, cfg) -> dict:
    """The port's plain ``flash_attention_triangle`` on CUDA tensors (layer
    0's q, k, v cast to f32: the same values) against the kernel on the
    bf16 inputs, at the per-call tolerance; each timed once."""
    import torch
    from repro_torch.kernels.sw_attention.kernel import sw_attention_cuda
    from repro_torch.models import layers as L
    q, k, v, pos = _layer0_qkv(params, batch, cfg)
    B, S, Hq, Dh = q.shape
    Hk = k.shape[2]

    def kernel():
        o = sw_attention_cuda(
            q.transpose(1, 2).reshape(B * Hk, Hq // Hk, S, Dh).contiguous(),
            k.transpose(1, 2).reshape(B * Hk, S, Dh).contiguous(),
            v.transpose(1, 2).reshape(B * Hk, S, Dh).contiguous(), window=S)
        return o.reshape(B, Hk, Hq // Hk, S, Dh).permute(0, 3, 1, 2, 4) \
            .reshape(B, S, Hq, Dh)
    chunk = min(cfg.attn_chunk, S)
    got, kernel_s = _timed(kernel)
    want, plain_s = _timed(lambda: L.flash_attention_triangle(
        q.float(), k.float(), v.float(), pos, pos, q_chunk=chunk,
        kv_chunk=chunk))
    ratio = _close_ratio(got, want)
    check(ratio <= 1.0, f"flash_attention_triangle at S {S} is {ratio:.3g} "
          f"of the tolerance off the kernel")
    return {"tolerance_ratio": ratio,
            "max_abs_err": float((got - want).abs().max()),
            "kernel_seconds": kernel_s, "plain_triangle_seconds": plain_s}


def _hold_kvq(cache, cfg, S: int, device) -> dict:
    """In f32 on layer 0 of a prefilled int8 cache: ``flash_attention_kvq``
    against ``flash_attention`` over the dequantized cache, a seeded f32
    query at position S (|got - want| <= 1e-4 |want| + 1e-4 max|want|)."""
    import torch
    from repro_torch.models import layers as L
    k8, v8 = cache["k"][0], cache["v"][0]
    ks, vs = cache["k_scale"][0], cache["v_scale"][0]
    q = torch.randn((k8.shape[0], 1, cfg.n_heads, cfg.head_dim),
                    generator=torch.Generator(
        device=device).manual_seed(SEED + 295), device=device)
    qpos = torch.tensor([S], dtype=torch.int32, device=device)
    got = L.flash_attention_kvq(q, k8, v8, ks, vs, qpos, cache["kpos"])
    want = L.flash_attention(q, k8.float() * ks[..., None],
                             v8.float() * vs[..., None], qpos,
                             cache["kpos"], q_chunk=1)
    ratio = _close_ratio(got, want)
    check(ratio <= 1.0, f"flash_attention_kvq is {ratio:.3g} of the "
          f"tolerance off flash_attention over the dequantized cache")
    return {"tolerance_ratio": ratio,
            "max_abs_err": float((got - want).abs().max())}


def _int8_faults(params, cache, tok, cfg) -> dict:
    """The first decode step's logits on two faulty copies of the int8
    cache, the controls of its checks: its scales left out (every scale 1)
    and the new token not written (``quantize_kv`` gives the zero row, so
    its slot stays as the prefill left it)."""
    import torch
    from repro_torch.models import get_model
    from repro_torch.models import layers as L
    ops = get_model(cfg)
    out = {}
    c = {k: x.clone() for k, x in cache.items()}
    c["k_scale"].fill_(1.0)
    c["v_scale"].fill_(1.0)
    out["scales_left_out"] = ops.decode_step(params, c, tok, cfg)[0]
    c = {k: x.clone() for k, x in cache.items()}
    quantize = L.quantize_kv

    def unwritten(x):
        return quantize(torch.zeros_like(x))
    L.quantize_kv = unwritten
    try:
        out["token_not_written"] = ops.decode_step(params, c, tok, cfg)[0]
    finally:
        L.quantize_kv = quantize
    del c
    return out


def _hold_new_slot(bf16_new: dict, c_int8, S: int, n: int) -> dict:
    """After ``n`` decode steps from position ``S`` on each cache: layer 0's
    slots S..S+n-1 of the int8 cache are ``quantize_kv`` of the bf16
    cache's (``bf16_new``: its layer 0 ``k`` and ``v`` there), bit for bit
    (layer 0's new K/V depend on the token alone); slot S+n and the rest
    hold the zero row; ``kpos`` is S..S+n-1 there."""
    import torch
    from repro_torch.models import layers as L
    new = slice(S, S + n)
    equal = all(
        torch.equal(got, want) for key in ("k", "v") for got, want in zip(
            (c_int8[key][0][:, new], c_int8[key + "_scale"][0][:, new]),
            L.quantize_kv(bf16_new[key])))
    empty = L.quantize_kv(torch.zeros((1, 1), device=c_int8["k"].device))[1]
    rest = all(bool((c_int8[key][:, :, S + n:] == 0).all())
               and bool((c_int8[key + "_scale"][:, :, S + n:] == empty).all())
               for key in ("k", "v"))
    kpos = c_int8["kpos"][new].tolist() == list(range(S, S + n))
    return {"layer0_written_equal": equal, "rest_empty": rest,
            "kpos_set": kpos}


def _check_int8_decode(name: str, r: dict) -> None:
    """The int8 decode's checks: the next-token probabilities within
    ``PROB_TOL`` of the bf16 cache's; the logits within ``LOGITS_L2_TOL``
    of them (relative L2), and the decode with its scales left out beyond
    it; the new slots written (:func:`_hold_new_slot`: over a 32k cache
    one unwritten token moves the logits too little for their bound, and
    its reading is only reported)."""
    check(r["max_prob_gap"] < PROB_TOL, f"{name}: the int8 decode's "
          f"next-token probabilities are {r['max_prob_gap']:.3g} off the "
          f"bf16 cache's")
    check(r["logits_rel_l2"] < LOGITS_L2_TOL, f"{name}: the int8 decode's "
          f"logits are {r['logits_rel_l2']:.3g} off the bf16 cache's "
          f"(relative L2; the bound {LOGITS_L2_TOL})")
    fault = r["faults_logits_rel_l2"]["scales_left_out"]
    check(fault > LOGITS_L2_TOL, f"{name}: the logits bound cannot see a "
          f"decode with its scales left out: {fault:.3g} from the bf16 "
          f"cache's")
    check(all(r["new_slot"].values()), f"{name}: the int8 decode's new "
          f"slots: {r['new_slot']}")


def phase_perf_variants(device, launches: dict, card: str) -> dict:
    """Phase 29(a)-(b): command-r-plus-104b at full width (4 of 64 layers,
    bf16) on a (1, 32768) prompt. The path ``launches["perf_variants"]``:
    for the variants off, then ``triangle_prefill`` and ``kv_quant`` on, a
    prefill (its peak; the logits and cache the checks read) and
    :func:`_serve_speeds` (a warm prefill and ``Server.generate`` of 16
    tokens, unprofiled, then a prefill under the profiler); sw_attention
    once a layer in each of the eight prefills. Then, outside the window:
    the two prefills' logits the same bits; the same two prefills with
    every sw_attention call held against its plain version; the int8
    cache's dtype and bytes; the first decode step on the bf16 and the
    int8 cache (:func:`_check_int8_decode`); the plain triangle attention
    against the kernel (:func:`_hold_triangle`); the int8 attention
    against the dequantized cache (:func:`_hold_kvq`)."""
    import torch
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.kernels import _build
    from repro_torch.models import get_model
    from repro_torch.training.serve import Server
    from repro_torch.utils.tree import tree_leaves

    S, new = PERF_VARIANTS["seq"], PERF_VARIANTS["new"]
    torch.cuda.reset_peak_memory_stats()
    cfg, cfg_on, params = _perf_model(device)
    init_peak = torch.cuda.max_memory_allocated() / 1e9
    batch = {"tokens": lm_batch(torch.Generator(device=device).manual_seed(
        SEED + 291), cfg, 1, S, device=device)["tokens"]}
    ops, ops_on = get_model(cfg), get_model(cfg_on)
    arms = {"off": (cfg, ops), "on": (cfg_on, ops_on)}
    got: dict = {}
    out: dict = {"params": sum(x.numel() for x in tree_leaves(params)),
                 "layers": cfg.n_layers, "prompt_tokens": S,
                 "init_peak_memory_gb": init_peak}
    laps = out["seconds"] = {}
    t0 = time.perf_counter()
    # the first prefill at this shape picks its GEMMs and grows the cache
    # of blocks: outside the window and the timing
    ops.prefill(params, batch, cfg)
    torch.cuda.synchronize()
    laps["warm_up"] = time.perf_counter() - t0
    _build.reset_launches()
    for arm, (c, o) in arms.items():
        # the prefill whose logits and cache the checks read, then the
        # speeds (a warm prefill and a generate, both unprofiled; one more
        # prefill under the profiler for the busy share)
        torch.cuda.reset_peak_memory_stats()
        got[arm] = o.prefill(params, batch, c)
        peak = torch.cuda.max_memory_allocated() / 1e9
        toks = []
        sp = _serve_speeds(Server(c, params), o, c, batch, new, toks)
        got[f"toks_{arm}"] = toks[0]
        out[f"prefill_{arm}"] = dict(
            seconds=sp["prefill_seconds"],
            tokens_per_s=sp["prefill_tokens_per_s"],
            busy_share=sp["prefill_profile"]["busy_share"],
            top_device_ms=sp["prefill_profile"]["top_device_ms"],
            peak_memory_gb=peak)
        out[f"decode_{arm}"] = dict(
            generate_seconds=sp["generate_seconds"],
            tokens_per_s=sp["decode_tokens_per_s"])
    launches["perf_variants"] = dict(_build.LAUNCHES)
    laps["path"] = time.perf_counter() - t0 - laps["warm_up"]
    n = launches["perf_variants"]["sw_attention"]
    check(n == 8 * cfg.n_layers and launches["perf_variants"]["ssd_intra"]
          == 0, f"sw_attention launched {n} times in eight 32k prefills, "
          f"not {8 * cfg.n_layers}")
    (l_off, c_off), (l_on, c_on) = got["off"], got["on"]
    check(torch.equal(l_off, l_on), "the triangle prefill's logits differ "
          "from the baseline's on the card")
    check(bool(torch.isfinite(l_off).all()) and l_off.shape == (
        1, 1, cfg.vocab), "bad 32k prefill logits")
    for arm in arms:
        check(got[f"toks_{arm}"].shape == (1, new), f"generated tokens of "
              f"shape {tuple(got[f'toks_{arm}'].shape)}")
    out["generated_tokens_equal"] = int(
        (got["toks_off"] == got["toks_on"]).sum())
    # the caches: int8 values at half the bf16 bytes, plus the f32 scales
    check(c_on["k"].dtype == torch.int8 and c_off["k"].dtype
          == torch.bfloat16 and c_on["k"].shape == c_off["k"].shape
          == (cfg.n_layers, 1, S + 64, cfg.n_kv_heads, cfg.head_dim),
          f"caches {c_off['k'].dtype} {tuple(c_off['k'].shape)}, "
          f"{c_on['k'].dtype} {tuple(c_on['k'].shape)}")
    scale_gb = 2 * c_on["k_scale"].numel() * 4 / 1e9
    out["cache_gb"] = {"bf16": _cache_gb(c_off), "int8": _cache_gb(c_on),
                       "int8_scales": scale_gb}
    check(abs(_cache_gb(c_on) - (_cache_gb(c_off) / 2 + scale_gb)) < 1e-9,
          f"the int8 cache is {out['cache_gb']}")
    # the first decode step on each cache (the two prefills' last logits
    # are the same bits, so the same token), and on two faulty copies of
    # the int8 cache
    tok = torch.argmax(l_off[:, -1], dim=-1)[:, None].to(torch.int32)
    faults = _int8_faults(params, c_on, tok, cfg_on)
    d_off = ops.decode_step(params, c_off, tok, cfg)[0]
    d_on = ops_on.decode_step(params, c_on, tok, cfg_on)[0]
    out["first_decode"] = {
        "max_prob_gap": _prob_gap(d_off, d_on),
        "logits_rel_l2": _rel_l2(d_on, d_off),
        "faults_logits_rel_l2": {k: _rel_l2(d, d_off)
                                 for k, d in faults.items()},
        "new_slot": _hold_new_slot(
            {key: c_off[key][0][:, S:S + 1] for key in ("k", "v")}, c_on, S,
            1)}
    _check_int8_decode("29(b)", out["first_decode"])
    out["kvq_vs_dequantized_f32"] = _hold_kvq(c_on, cfg, S, device)
    del c_off, c_on, d_off, d_on, got, faults
    t1 = time.perf_counter()
    # every sw_attention call of both prefills against its plain version
    with kernel_route("checked") as ratios:
        for arm, (c, o) in arms.items():
            again = o.prefill(params, batch, c)[0]
            check(torch.equal(again, l_off), f"the {arm} prefill's logits "
                  f"differ between two runs")
            del again
    worst = max(ratios["sw_attention"])
    check(len(ratios["sw_attention"]) == 2 * cfg.n_layers and worst <= 1.0,
          f"{len(ratios['sw_attention'])} sw_attention calls, the worst "
          f"{worst:.3g} of the tolerance")
    out["per_call_worst_ratio"] = worst
    # where each call's worst element lies: the call (layer, arm), the
    # (bh, g, query row, d) index, the values there and max|want|
    out["per_call_worst"] = [
        dict(w, layer=i % cfg.n_layers, arm=list(arms)[i // cfg.n_layers])
        for i, w in enumerate(ratios["sw_attention_worst"])]
    laps["checked_prefills"] = time.perf_counter() - t1
    out["triangle_vs_kernel"] = _hold_triangle(params, batch, cfg)
    out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    laps["all"] = time.perf_counter() - t0
    log(f"phase 29(a-b): command-r-plus-104b ({cfg.n_layers} layers), a "
        f"32k prompt, variants off and on, on {card}: {json.dumps(out)}")
    return out, params


def phase_perf_decode(device, params, card: str) -> dict:
    """Phase 29(c): the decode memory term at 32k. A cache of 32,832 slots
    (a 32k prefill's, with its 64 free slots) filled at positions 0-32767
    straight from seeded bf16 draws, at batch ``PERF_DECODE["batch"]``;
    the int8 arm gets ``quantize_kv`` of the same draws (its free slots
    the zero-row scale, as a prefill leaves them). Each arm
    alone beside the model: ``PERF_DECODE["steps"]`` decode steps on the
    same seeded tokens under the profiler (seconds a step, busy share),
    its cache's bytes and its peak. Across the arms, each step's
    next-token probabilities within ``PROB_TOL`` and its logits within
    ``LOGITS_L2_TOL``, the int8 cache's faulty copies beyond it
    (:func:`_check_int8_decode`)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import get_model, transformer
    from repro_torch.models import layers as L

    cfg = dataclasses.replace(get_config("command-r-plus-104b"),
                              n_layers=PERF_VARIANTS["layers"])
    B, steps, S = PERF_DECODE["batch"], PERF_DECODE["steps"], \
        PERF_VARIANTS["seq"]
    spec = transformer.CacheSpec(cache_len=S + 64, ring=False)
    toks = torch.randint(0, cfg.vocab, (steps, B, 1), dtype=torch.int32,
                         generator=torch.Generator(device=device).manual_seed(
                             SEED + 296), device=device)

    def filled(c):
        """The cache of ``c`` at 32,832 slots: positions 0-32767 the seeded
        draws, the 64 free slots zeros; under ``kv_quant`` each layer's
        whole cache quantized, as a prefill leaves it."""
        cache = transformer.init_cache(None, c, B, spec, device)
        for i in range(c.n_layers):
            gen = torch.Generator(device=device).manual_seed(SEED + 297 + i)
            for key in ("k", "v"):
                x = torch.zeros(cache[key][i].shape, dtype=torch.bfloat16,
                                device=device)
                x[:, :S] = torch.randn(
                    (B, S, c.n_kv_heads, c.head_dim), generator=gen,
                    device=device)
                if c.kv_quant:
                    cache[key][i], cache[key + "_scale"][i] = \
                        L.quantize_kv(x)
                else:
                    cache[key][i] = x
                del x
        cache["kpos"][:S] = torch.arange(S, dtype=torch.int32, device=device)
        cache["pos"].fill_(S)
        return cache

    out, logits = {}, {}
    t0 = time.perf_counter()
    for arm, c in (("bf16", cfg), ("int8", dataclasses.replace(
            cfg, kv_quant=True))):
        ops = get_model(c)
        cache = filled(c)
        if c.kv_quant:
            faults = _int8_faults(params, cache, toks[0], c)
        arm_logits = logits[arm] = []
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

        def run():
            for t in toks:
                arm_logits.append(ops.decode_step(params, cache, t, c)[0])
        share = device_share(run)
        out[arm] = {"seconds_per_step": share["wall_s"] / steps,
                    "busy_share": share["busy_share"],
                    "top_device_ms": share["top_device_ms"],
                    "cache_gb": _cache_gb(cache),
                    "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
        if c.kv_quant:
            new_slot = _hold_new_slot(bf16_new, cache, S, steps)
        else:
            bf16_new = {key: cache[key][0][:, S:S + steps].clone()
                        for key in ("k", "v")}
        del cache
    pairs = list(zip(logits["bf16"], logits["int8"]))
    first = logits["bf16"][0]
    out.update(batch=B, steps=steps, cache_slots=S + 64, int8_decode=dict(
        max_prob_gap=max(_prob_gap(b, q) for b, q in pairs),
        logits_rel_l2=max(_rel_l2(q, b) for b, q in pairs),
        faults_logits_rel_l2={k: _rel_l2(d, first) for k, d in faults.items()},
        new_slot=new_slot), seconds=time.perf_counter() - t0)
    _check_int8_decode("29(c)", out["int8_decode"])
    check(out["int8"]["peak_memory_gb"] < out["bf16"]["peak_memory_gb"],
          f"29(c): the int8 decode's peak is not below the bf16 one's: "
          f"{out['int8']['peak_memory_gb']:.2f} GB against "
          f"{out['bf16']['peak_memory_gb']:.2f}")
    log(f"phase 29(c): command-r-plus-104b decode over a 32k cache, batch "
        f"{B}, {steps} steps, bf16 against int8, on {card}: "
        f"{json.dumps(out)}")
    return out


def _close_1e4(a, b) -> float:
    """max |a - b| / (1e-4 + 1e-4 |b|); <= 1 passes."""
    a, b = a.cpu().float(), b.cpu().float()
    return float(((a - b).abs() / (1e-4 + 1e-4 * b.abs())).max())


def phase_perf_reduced(device) -> dict:
    """Phase 29(d): each of ``PERF_REDUCED`` at its reduced config in f32
    with ``kv_quant`` and ``triangle_prefill`` on, on the card and on the
    CPU from the same weights and prompts: the prefill's logits and a
    decode step's (on the CPU's cache, carried to the card: the two
    prefills' int8 caches may sit one count apart, which are counted)
    within rtol 1e-4, atol 1e-4; ``Server.generate``'s 6 tokens equal."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.training.serve import Server
    from repro_torch.utils.tree import tree_map

    out = {}
    t0 = time.perf_counter()
    for name in PERF_REDUCED:
        cfg = dataclasses.replace(get_config(name, reduced=True),
                                  kv_quant=True, triangle_prefill=True)
        ops = get_model(cfg)
        params = ops.init_params(torch.Generator().manual_seed(SEED + 293),
                                 cfg, device="cpu")
        rng = np.random.default_rng(SEED + 294)
        batch = {"tokens": torch.from_numpy(rng.integers(
            0, cfg.vocab, (2, 64)).astype(np.int32))}
        if cfg.family == "vlm":
            batch["patches"] = torch.from_numpy(rng.standard_normal(
                (2, cfg.n_patches, cfg.vit_dim)).astype(np.float32))
        gparams = tree_map(lambda x: x.to(device), params)
        gbatch = {k: v.to(device) for k, v in batch.items()}
        l_cpu, c_cpu = ops.prefill(params, batch, cfg)
        l_gpu, c_gpu = ops.prefill(gparams, gbatch, cfg)
        flips = sum(int((c_gpu[k].cpu().int() - c_cpu[k].int()).abs().sum())
                    for k in ("k", "v"))
        tok = torch.argmax(l_cpu[:, -1], dim=-1)[:, None].to(torch.int32)
        carried = tree_map(lambda x: x.to(device), c_cpu)
        d_gpu = ops.decode_step(gparams, carried, tok.to(device), cfg)[0]
        d_cpu = ops.decode_step(params, c_cpu, tok, cfg)[0]
        t_cpu = Server(cfg, params, device="cpu").generate(batch, 6)
        t_gpu = Server(cfg, gparams, device=device).generate(gbatch, 6)
        r = {"prefill_ratio": _close_1e4(l_gpu, l_cpu),
             "decode_ratio": _close_1e4(d_gpu, d_cpu),
             "cache_int8_flips": flips,
             "tokens_equal": bool(torch.equal(t_gpu.cpu(), t_cpu))}
        check(c_gpu["k"].dtype == torch.int8 and r["tokens_equal"]
              and r["prefill_ratio"] <= 1.0 and r["decode_ratio"] <= 1.0,
              f"29(d) {name}: the card and the CPU differ: {r}")
        out[name] = r
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 29(d): the reduced configs with both variants, card against "
        f"CPU: {json.dumps(out)}")
    return out


def perf_variant_phases(device, launches: dict, card: str) -> dict:
    import torch
    out, params = phase_perf_variants(device, launches, card)
    gc.collect()
    torch.cuda.empty_cache()
    out = {"perf_variants": out,
           "perf_decode": phase_perf_decode(device, params, card)}
    del params
    gc.collect()
    torch.cuda.empty_cache()
    out["perf_reduced"] = phase_perf_reduced(device)
    return out


def perf_variants_only(device, card: str) -> int:
    """``--perf-variants``: phase 14 and phase 29 alone. Its last line
    says that it is this run, not the full one."""
    import torch
    kernels = phase_serve_kernels(device)
    launches: dict = {}
    out = perf_variant_phases(device, launches, card)
    check(launches["perf_variants"]["sw_attention"] > 0,
          "sw_attention was not launched on the perf_variants path")
    log(json.dumps({"launches": launches, "serve_kernels": kernels}))
    log(card)
    log(json.dumps({"perf_variants_only": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}, "phases": list(out)}))
    return 0


def erasure_only(a_tree, device, int_rate: float, card: str) -> int:
    """``--erasure``: phase 3's parity_xor encode and phase 9 alone, with
    the erasure kernels' SASS instruction mix. Its last line says that it
    is this partial run, never the full run's ``{"ok": true, ...}``."""
    import torch
    from repro_torch.core.arena import pack_arena
    from repro_torch.core.blocks import partition_pytree
    from repro_torch.fabric import CheckpointFabric, FabricConfig

    fab = CheckpointFabric(partition_pytree(a_tree, BLOCK_ROWS),
                           FabricConfig())
    x = pack_arena(a_tree, fab.arena_layout)
    par = whole_arena_parity_xor(x, fab.arena_layout, fab.parity, device)
    log(f"parity_xor (whole arena): kernel {par['ms']:.3f} ms, plain "
        f"{par['plain_ms']:.3f} ms, bound {par['bound_ms']:.3f} ms "
        f"({par['bound_by']}{rate_note(par)})")
    del x, fab
    torch.cuda.empty_cache()
    rs = phase_rs_kernels(a_tree, device, int_rate)
    log(json.dumps({"parity_xor": par,
                    "gf256_mac_shapes": rs["gf256_mac"]["shapes"],
                    "sass": sass_mix(("gf256", "parity", "erasure"))}))
    log(card)
    log(json.dumps({"erasure_only": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# ---------------------------------------------------------------------------
# phase 30: the sharded arena and the elastic mesh
# ---------------------------------------------------------------------------

# qwen2-1.5b at full width, f32 (the meshed fabric holds an all-f32 model),
# on a (2, 2) mesh of 4 ranks sharing the one card: one sequence of 2,048
# tokens a rank; host 1 (ranks 2 and 3) lost at step 3, healed at step 5.
# 2 of its 28 layers: with 4 the ranks' peaks summed to 70.2 GB (the two
# survivors hold twice the spans and twice the batch while the mesh is
# shrunk; PERF.md, phase 30); 2, not 3, for the script's time budget
MESH = dict(ranks=4, shape=(2, 2), layers=2, batch=4, seq=2048, steps=6,
            loss_step=3, heal_after=2, eq_steps=2, seed=30, timeout=900)
MESH_KERNELS = ("arena_maintain", "arena_scatter", "parity_xor")
# the ranks' losses against the one-rank run's: the gradient is the mean of
# four per-rank means, summed by gloo in another order than one device sums
# the batch (float32 rounding only; recoveries apply no perturbation)
MESH_LOSS_RTOL = 1e-4


def _mesh_cfg(opts: dict):
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config("qwen2-1.5b", reduced=opts.get("reduced", False))
    return dataclasses.replace(cfg, n_layers=opts["layers"],
                               dtype="float32")


def _mesh_loop(cfg, device, *, ctx=None, arena: bool = True,
               recorder=None, elastic: bool = True, optimizer=None):
    """``TrainLoop`` with ``optimizer`` (default adamw(3e-4)),
    ``CheckpointPolicy.scar(0.125, 2)`` and the 2-host, 4-device fabric
    (elastic unless asked otherwise)."""
    from repro_torch.core.policy import CheckpointPolicy
    from repro_torch.fabric import FabricConfig
    from repro_torch.optim import adamw
    from repro_torch.training import TrainLoop, TrainLoopConfig
    return TrainLoop(cfg, optimizer or adamw(3e-4), TrainLoopConfig(
        policy=CheckpointPolicy.scar(fraction=0.125, interval=2),
        fabric=FabricConfig(n_devices=MESH["ranks"], devices_per_host=2,
                            elastic=elastic),
        arena_state=arena, recorder=recorder), device=device, ctx=ctx)


def _mesh_schedule(loop, first_step: int) -> None:
    """Phase 30's host loss and heal, for a run() whose first step is
    ``first_step``."""
    loop.loop_cfg.fail_schedule = [(MESH["loss_step"] - first_step + 1,
                                    "host", 1)]
    loop.loop_cfg.heal_after = MESH["heal_after"]


def _mesh_rank_body(rank: int, opts: dict) -> dict:
    """One rank of phase 30 (see :func:`phase_mesh`)."""
    import numpy as np
    import torch
    from repro_torch.core.arena import pack_arena
    from repro_torch.data import ShardedLMDataset
    from repro_torch.distributed import collectives
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding.partition import make_dist_ctx
    from repro_torch.telemetry import Recorder
    from repro_torch.training import ArenaTrainState

    device = torch.device(opts["device"])
    cuda = device.type == "cuda"
    cfg = _mesh_cfg(opts)
    mesh = make_host_mesh(model=MESH["shape"][1])
    check(tuple(mesh.devices.shape) == MESH["shape"], f"mesh {mesh}")
    ctx = make_dist_ctx(mesh)
    B, S, eq = opts["batch"], opts["seq"], MESH["eq_steps"]
    out = {"rank": rank, "position": mesh.position()}

    params = _load_mesh_params(opts["params"])

    def peak() -> float:
        return torch.cuda.max_memory_allocated() / 1e9 if cuda else 0.0

    def free() -> None:
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()

    # (b) the PyTree loop on the same mesh, eq_steps steps (a save among
    # them); the arena loop's first steps are held to it below
    free()
    py = _mesh_loop(cfg, device, ctx=ctx, arena=False)
    st = py.init_state(params=params)
    st = py.run(st, iter(ShardedLMDataset(cfg, B, S, seed=0, device=device,
                                          ctx=ctx)), eq)
    lay = py.controller.arena_layout
    w0, w1 = lay.span(mesh.position())
    tree = {"losses": [m["loss"] for m in py.metrics],
            "ckpt": py.controller._ckpt_arena.cpu(),
            "final": pack_arena(st.params, lay)[w0:w1].cpu(),
            "saves": py.controller.stats["saves"]}
    out["pytree_peak_gb"] = peak()
    del py, st
    free()

    # (a) the arena loop: eq_steps clean steps, then the host loss and the
    # heal through a shrink and a re-grow
    rec = Recorder()
    loop = _mesh_loop(cfg, device, ctx=ctx, recorder=rec)
    state = loop.init_state(params=params)
    del params
    check(isinstance(state, ArenaTrainState)
          and state.arena.numel() == loop.arena_layout.shard_words,
          "the mesh loop did not hold its span of the arena")
    shards = [loop.arena_layout.shards]
    it = iter(ShardedLMDataset(cfg, B, S, seed=0, device=device, ctx=ctx))
    _build.reset_launches()
    collectives.reset_stats()
    t0 = time.perf_counter()
    state = loop.run(state, it, eq)
    ctl, fab = loop.controller, loop.controller.fabric
    check([m["loss"] for m in loop.metrics] == tree["losses"],
          f"rank {rank}: arena losses {[m['loss'] for m in loop.metrics]}, "
          f"PyTree {tree['losses']}")
    check(torch.equal(ctl._ckpt_arena.cpu(), tree["ckpt"]),
          f"rank {rank}: the checkpoint span differs between the paths")
    check(torch.equal(state.arena.cpu(), tree["final"]),
          f"rank {rank}: the parameter span differs between the paths")
    check(tree["saves"] == ctl.stats["saves"] >= 1,
          f"rank {rank}: saves {tree['saves']} and {ctl.stats['saves']}")
    out["bit_equal"] = {"losses": tree["losses"], "saves": tree["saves"],
                        "span_words": int(w1 - w0)}
    del tree
    _mesh_schedule(loop, eq + 1)
    state = loop.run(state, it, opts["steps"] - eq)
    if cuda:
        torch.cuda.synchronize()
    out["run_seconds"] = time.perf_counter() - t0
    out["launches"] = dict(_build.LAUNCHES)
    out["collectives"] = collectives.seconds_and_bytes()
    out["peak_gb"] = peak()
    m = loop.metrics
    out["losses"] = [x["loss"] for x in m]
    out["step_seconds"] = [x["seconds"] for x in m]
    out["idle_steps"] = [x["step"] for x in m if x.get("idle")]
    resizes = [(x["step"], x["mesh_resize"]) for x in m
               if "mesh_resize" in x]
    shards += [r["shards"] for _, r in resizes]
    out["shards"] = shards
    out["resizes"] = resizes
    out["failures"] = [f for x in m for f in x.get("failures", [])]
    out["recovery_seconds"] = rec.tracer.durations("recovery")
    out["heal_seconds"] = rec.tracer.durations("heal")
    out["stats"] = {k: fab.stats[k] for k in (
        "mesh_resizes", "live_packs", "arena_maintains",
        "arena_resident_maintains", "ici_bytes_moved", "dcn_bytes_moved",
        "recoveries", "heals")}
    out["events"] = sorted({e["kind"] for e in rec.events})
    check(loop.arena_layout.shards == MESH["ranks"]
          and fab.view.n_alive_devices == MESH["ranks"],
          f"rank {rank}: not re-grown to {MESH['ranks']} shards")

    # the 4-rank sweep against the plain sweep of the whole arena: one
    # more forced maintain with the checkpoint (scores summed over the
    # mesh), the tiers gathered at the first rank and held there
    step = fab.last_maintained_step
    fab.maintain(step, state.arena, ckpt_values=ctl._ckpt_arena, force=True)
    scores = fab.last_scores.clone()
    free()
    comm = fab.comm
    full = comm.gather(state.arena)
    ck = comm.gather(ctl._ckpt_arena)
    rep, par = fab.gather_tiers()
    if comm.is_root:
        out["sweep_vs_plain"] = _hold_mesh_sweep(fab, full, ck, rep, par,
                                                 scores)
    del full, ck, rep, par
    # every kernel of the path against its plain version on this rank's
    # span, at the shapes the path gave it
    out["holds"] = _hold_mesh_rank(loop, state, scores)
    out["final_peak_gb"] = peak()
    out["host_peak_gb"] = _host_peak_gb()
    return out


@contextlib.contextmanager
def mesh_route_plain():
    """A switch of this script around the mesh path's dispatchers: CUDA
    tensors go to the plain versions of arena_maintain, arena_scatter,
    parity_xor, masked_restore and block_dist. Fails if a kernel launched
    inside it."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.block_dist import ops as bd
    from repro_torch.kernels.block_dist.ref import block_dist_ref
    from repro_torch.kernels.fused_maintain import ops as fm
    from repro_torch.kernels.fused_maintain.ref import (arena_maintain_ref,
                                                        arena_scatter_ref)
    from repro_torch.kernels.masked_restore import ops as mr
    from repro_torch.kernels.masked_restore.ref import masked_restore_ref
    from repro_torch.kernels.parity_xor import ops as px
    from repro_torch.kernels.parity_xor.ref import parity_xor_ref

    def xor_plain(out, src, base, plan):
        return parity_xor_ref(out, src, base, plan.on(out.device))
    swaps = [(fm, "arena_maintain_cuda", arena_maintain_ref),
             (fm, "arena_scatter_cuda", arena_scatter_ref),
             (mr, "masked_restore_cuda", masked_restore_ref),
             (bd, "block_dist_cuda", block_dist_ref),
             (px, "parity_xor", xor_plain)]
    saved = [(m, name, getattr(m, name)) for m, name, _ in swaps]
    before = dict(_build.LAUNCHES)
    for m, name, f in swaps:
        setattr(m, name, f)
    try:
        yield
    finally:
        for m, name, f in saved:
            setattr(m, name, f)
    check(dict(_build.LAUNCHES) == before, "a kernel launched on the plain "
          "route")


def _hold_mesh_sweep(fab, full, ck, rep, par, scores) -> dict:
    """At the mesh's first rank: the gathered replica is the gathered live
    arena, the gathered parity (every rank's span sweep, combined into the
    owners' rows) is the plain sweep's of the whole arena bit for bit,
    the mesh's summed scores within rtol 1e-4 of its scores
    (arena_maintain's plain version over the one-rank tables)."""
    import torch
    from repro_torch.kernels.fused_maintain.ops import sweep_plan
    from repro_torch.kernels.fused_maintain.ref import arena_maintain_ref
    codec = fab.parity
    t = sweep_plan(fab.arena_layout, codec.layout,
                   codec.group_of).on(full.device)
    fe = codec.layout.frame_elems
    par_p = torch.zeros((codec.n_groups * fe,), dtype=torch.int32,
                        device=full.device)
    s_p = arena_maintain_ref(full, ck, t, par_p, None)
    check(torch.equal(rep, full), "the 4-rank replica differs from the live "
          "arena")
    check(torch.equal(par, par_p.view(codec.n_groups, fe)), "the 4-rank "
          "parity differs from the plain sweep's")
    rel = _rel_err(scores, s_p)
    check(rel <= 1e-4, f"the 4-rank scores are off the plain sweep's by "
          f"rtol {rel}")
    return {"scores_rtol": rel, "parity_words": int(par_p.numel()),
            "replica_words": int(full.numel())}


def _hold_mesh_rank(loop, state, scores) -> dict:
    """On every rank, after the path's launch counts were read: each
    kernel of the mesh path on this rank's span, at the shapes the path
    gave it, against its plain version on the same inputs
    (:func:`mesh_route_plain`). The span sweep (arena_maintain over the
    span's tables, then the XOR combine's parity_xor into the owned rows):
    replica and rows bit for bit, scores within rtol 1e-4. The save of
    the sweep's top-scored eighth (arena_scatter) against a plain index
    copy, bit for bit. Phase 30's host loss replayed on this span: the
    restore of the lost blocks (masked_restore over the span's tiles from
    the first lost one to the last, and over its tail words), bit for bit,
    and the per-block distances of the span (block_dist), rtol 1e-4."""
    import numpy as np
    import torch
    from repro_torch.core.checkpoint import top_k_indices
    from repro_torch.fabric import span_recovery as sr
    from repro_torch.kernels.fused_maintain.ops import (arena_scatter_save,
                                                        save_ranges)
    ctl = loop.controller
    fab, comm, lay = ctl.fabric, ctl.fabric.comm, ctl.fabric.arena_layout
    span, ck = state.arena, ctl._ckpt_arena
    total = ctl.partition.total_blocks
    prog = fab._arena_maintain_fn()
    got = [x.clone() for x in prog(span, ck, comm, copy=True)]
    with mesh_route_plain():
        want = [x.clone() for x in prog(span, ck, comm, copy=True)]
    check(torch.equal(got[0], want[0]) and torch.equal(got[2], want[2]),
          f"rank {comm.pos}: the span sweep's replica or parity rows differ "
          f"from the plain route's")
    out = {"sweep_scores_rtol": _rel_err(got[1], want[1])}
    check(out["sweep_scores_rtol"] <= 1e-4, f"rank {comm.pos}: span sweep "
          f"scores off by rtol {out['sweep_scores_rtol']}")
    del got, want

    w0, w1 = lay.span(comm.pos)
    ids = top_k_indices(scores, ctl.partition.blocks_for_k(
        ctl.policy.fraction)).cpu().numpy()
    dst, _ = arena_scatter_save(ck.clone(), span, lay, ids, span=(w0, w1))
    off, length = save_ranges(lay, ids)
    lo, hi = np.maximum(off, w0), np.minimum(off + length, w1)
    keep = hi > lo
    idx = torch.from_numpy(np.concatenate(
        [np.arange(a, b) for a, b in zip(lo[keep] - w0, hi[keep] - w0)]
        or [np.empty((0,), np.int64)])).to(span.device)
    plain = ck.clone()
    plain[idx] = span[idx]
    check(torch.equal(dst, plain), f"rank {comm.pos}: the span save differs "
          f"from a plain index copy")
    out["save_words"] = int(idx.numel())
    del dst, plain, idx

    hosts = np.asarray(fab.domains.host_of(np.arange(fab.cfg.n_devices)))
    lost = np.isin(fab.view.homes, np.nonzero(hosts == 1)[0])
    tables = sr.span_tables(lay, comm.pos)
    restored = span.clone()
    sr.span_restore(restored, ck, lost, tables)
    with mesh_route_plain():
        plain = span.clone()
        sr.span_restore(plain, ck, lost, tables)
        d_p = sr.span_block_sq(span, ck, tables, total)
    check(torch.equal(restored, plain), f"rank {comm.pos}: the span restore "
          f"differs from the plain restore")
    d_k = sr.span_block_sq(span, ck, tables, total)
    hit = d_p > 0
    out["block_dist_rtol"] = float(np.max(np.abs(d_k - d_p)[hit]
                                          / d_p[hit], initial=0.0))
    check(out["block_dist_rtol"] <= 1e-4 and np.all(d_k[~hit] == 0),
          f"rank {comm.pos}: span block_dist off by rtol "
          f"{out['block_dist_rtol']}")
    out["lost_blocks"] = int(lost.sum())
    out["lost_in_span"] = bool(lost[tables.tile_gid].any()
                               or lost[tables.tail_gid].any())
    out["restored_words"] = int((restored != span).sum())
    return out


def _host_peak_gb() -> float:
    """This process's peak resident host memory, in GB."""
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9


def _mesh_rank(rank: int, world: int, rdv: str, out_dir: str,
               opts: dict) -> None:
    """Spawned rank of phase 30: joins the gloo group, runs
    :func:`_mesh_rank_body`, writes its report."""
    import datetime
    import torch
    import torch.distributed as dist
    if opts["device"] == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo", init_method=f"file://{rdv}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=MESH["timeout"]))
    try:
        out = _mesh_rank_body(rank, opts)
        Path(out_dir, f"rank{rank}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()


def _save_mesh_params(device, opts: dict, where: Path, cfg=None):
    """Phase 30's initial weights (or ``cfg``'s), drawn once here from the
    seed, as one ``.npy`` a leaf under ``where`` (every rank and the
    one-rank run load them: no rank draws its own). Returns them as a
    numpy tree."""
    import pickle
    import numpy as np
    import torch
    from repro_torch.interop import to_numpy_tree
    from repro_torch.models import get_model
    from repro_torch.utils.tree import tree_flatten, tree_unflatten
    cfg = cfg or _mesh_cfg(opts)
    drawn = get_model(cfg).init_params(torch.Generator(
        device=device).manual_seed(opts["seed"]), cfg, device=device)
    leaves, treedef = tree_flatten(to_numpy_tree(drawn))
    del drawn
    where.mkdir(parents=True, exist_ok=True)
    for i, x in enumerate(leaves):
        np.save(where / f"{i}.npy", x)
    (where / "treedef.pkl").write_bytes(pickle.dumps(treedef))
    return tree_unflatten(treedef, leaves)


def _load_mesh_params(where: str):
    """The numpy tree :func:`_save_mesh_params` wrote (memory-mapped)."""
    import pickle
    import numpy as np
    from repro_torch.utils.tree import tree_unflatten
    treedef = pickle.loads(Path(where, "treedef.pkl").read_bytes())
    n = len(list(Path(where).glob("*.npy")))
    return tree_unflatten(treedef, [np.load(Path(where, f"{i}.npy"),
                                            mmap_mode="r")
                                    for i in range(n)])


def _mesh_one_rank(device, opts: dict, params) -> dict:
    """The one-rank run of phase 30's model, weights, batches and
    schedule (no mesh), for the ranks' losses and step time."""
    import torch
    from repro_torch.data import ShardedLMDataset
    cfg = _mesh_cfg(opts)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    loop = _mesh_loop(cfg, device)
    state = loop.init_state(params=params)
    it = iter(ShardedLMDataset(cfg, opts["batch"], opts["seq"], seed=0,
                               device=device))
    state = loop.run(state, it, MESH["eq_steps"])
    _mesh_schedule(loop, MESH["eq_steps"] + 1)
    state = loop.run(state, it, opts["steps"] - MESH["eq_steps"])
    m = loop.metrics
    out = {"losses": [x["loss"] for x in m],
           "step_seconds": [x["seconds"] for x in m],
           "tier_counts": [f["tier_counts"] for x in m
                           for f in x.get("failures", [])],
           "peak_gb": (torch.cuda.max_memory_allocated() / 1e9
                       if device.type == "cuda" else 0.0),
           "arena_gb": loop.arena_layout.nbytes / 1e9,
           "parity_gb": loop.controller.fabric.redundancy_nbytes()["parity"]
           / 1e9}
    del loop, state, it
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def phase_mesh(device, launches: dict, card: str, opts=None) -> dict:
    """Phase 30: qwen2-1.5b at full width (f32, 2 of 28 layers) trained on
    a (2, 2) mesh of 4 ``torch.distributed`` ranks sharing the one card
    (gloo: NCCL refuses two ranks on one device; every collective staged
    through page-locked host memory, its bytes and seconds counted), under
    ``FabricConfig(n_devices=4, devices_per_host=2, elastic=True)``,
    ``scar(0.125, 2)`` and adamw(3e-4), batch 4 x 2048 (one sequence a
    rank), 6 steps: host 1 lost at step 3 (4 -> 2 shards), healed at step
    5 (2 -> 4). First the same model, weights, batches and schedule on one
    rank in this process. Held: the arena and PyTree loops on the mesh
    bit-equal over their first 2 steps (losses, the checkpoint spans, the
    parameter spans); the 4-rank sweep's replica and parity bit-equal to
    the plain sweep of the whole arena, its scores within rtol 1e-4; on
    every rank, each kernel of the path against its plain version at the
    path's shapes (:func:`_hold_mesh_rank`); the ranks' losses within
    ``MESH_LOSS_RTOL`` of the one-rank run's; the recovery all from the
    replicas, at zero perturbation; shards 4, 2, 4, two resizes, no live
    pack; arena_maintain, arena_scatter, parity_xor and block_dist
    launched on every rank, masked_restore on every rank whose span held
    a lost block (``launches["mesh"]``: one count a rank). A failed rank
    fails the phase."""
    import torch
    import torch.multiprocessing as mp
    opts = {"device": device.type, "layers": MESH["layers"],
            "batch": MESH["batch"], "seq": MESH["seq"],
            "steps": MESH["steps"], "seed": SEED + MESH["seed"],
            **(opts or {})}
    t_phase = time.perf_counter()
    work = ROOT / "build" / f"mesh_{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    opts["params"] = str(work / "params")
    params = _save_mesh_params(device, opts, work / "params")
    t0 = time.perf_counter()
    one = _mesh_one_rank(device, opts, params)
    one["seconds"] = time.perf_counter() - t0
    del params
    log(f"phase 30: one rank, {json.dumps(one)}")
    if device.type == "cuda":
        torch.cuda.empty_cache()
    rdv = work / "rendezvous"
    if rdv.exists():
        rdv.unlink()
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    t0 = time.perf_counter()
    procs = mp.start_processes(
        _mesh_rank, args=(MESH["ranks"], str(rdv), str(work), opts),
        nprocs=MESH["ranks"], join=False, start_method="spawn")
    deadline = time.monotonic() + MESH["timeout"]
    try:
        while not procs.join(timeout=5):
            if time.monotonic() > deadline:
                raise AssertionError(f"phase 30: the ranks did not finish "
                                     f"in {MESH['timeout']} s")
    finally:
        for p in procs.processes:
            if p.is_alive():
                p.terminate()
                p.join(30)
    wall = time.perf_counter() - t0
    ranks = [json.loads((work / f"rank{r}.json").read_text())
             for r in range(MESH["ranks"])]
    shutil.rmtree(work, ignore_errors=True)
    launches["mesh"] = [r["launches"] for r in ranks]
    for r in ranks:
        for name in MESH_KERNELS:
            check(r["launches"][name] > 0, f"{name} was not launched on "
                  f"rank {r['rank']} of the mesh path")
        check(r["shards"] == [4, 2, 4], f"rank {r['rank']}: shards "
              f"{r['shards']}")
        check(r["stats"]["mesh_resizes"] == 2
              and r["stats"]["live_packs"] == 0,
              f"rank {r['rank']}: {r['stats']}")
        check(r["losses"] == ranks[0]["losses"],
              f"rank {r['rank']}: losses {r['losses']}")
    rel = max(abs(a - b) / abs(b) for a, b in zip(ranks[0]["losses"],
                                                  one["losses"]))
    check(rel <= MESH_LOSS_RTOL and all(math.isfinite(x)
                                        for x in ranks[0]["losses"]),
          f"mesh losses {ranks[0]['losses']}, one rank {one['losses']}")
    check("sweep_vs_plain" in ranks[0], "the sweep check did not run")
    # the recovery ran on every span: the norms' block_dist everywhere, the
    # replica restore's masked_restore on the spans that hold lost blocks;
    # the replicas were fresh, so it applied no perturbation
    fail, = ranks[0]["failures"]
    check(fail["tier_counts"]["PEER_REPLICA"] == fail["lost_blocks"]
          == ranks[0]["holds"]["lost_blocks"] > 0
          and fail["applied_sq"] == 0.0, f"mesh recovery {fail}")
    for r in ranks if device.type == "cuda" else ():
        check(r["launches"]["block_dist"] > 0
              and (r["launches"]["masked_restore"] > 0
                   or not r["holds"]["lost_in_span"]),
              f"rank {r['rank']}: the recovery's kernels did not launch "
              f"({r['launches']})")
    peaks = [r["peak_gb"] for r in ranks]
    member = [s for i, s in enumerate(ranks[0]["step_seconds"])
              if i + 1 not in ranks[0]["idle_steps"]]
    # each rank's collectives summed (the arena run's, from its first step
    # through the resizes to the last): what the gloo staging costs
    totals = [{k: sum(v[k] for v in r["collectives"].values())
               for k in ("calls", "bytes", "seconds", "staged_bytes")}
              for r in ranks]
    out = {"one_rank": one, "ranks": ranks, "max_rel_loss_diff": rel,
           "collective_totals": totals,
           "rank_peak_gb": peaks, "summed_peak_gb": sum(peaks),
           "pytree_peak_gb": [r["pytree_peak_gb"] for r in ranks],
           "spawn_to_join_seconds": wall,
           "median_step_seconds": {"one_rank": statistics.median(
               one["step_seconds"]), "mesh": statistics.median(member)},
           "resize_seconds": [r["seconds"] for _, r in ranks[0]["resizes"]],
           "card": card}
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 30: the sharded arena and the elastic mesh, {card}: "
        f"{json.dumps(out)}")
    return out


def mesh_only(device, card: str) -> int:
    """``--mesh``: phase 30 alone. Its last line says that it is this
    partial run, never the full run's ``{"ok": true, ...}``."""
    import torch
    launches = {}
    out = phase_mesh(device, launches, card)
    log(json.dumps({"launches": launches["mesh"]}))
    log(card)
    log(json.dumps({"mesh_only": True, "seconds": out["seconds"],
                    "device": {"platform": "gpu",
                               "kind": torch.cuda.get_device_name(0),
                               "count": torch.cuda.device_count()}}))
    return 0


# ---------------------------------------------------------------------------
# phase 31: the tensor- and expert-parallel forward on a mesh
# ---------------------------------------------------------------------------

# (a) qwen3-moe-235b-a22b at full width with 1 of its 94 layers (bf16, the
# router f32: 3.73 G values) on a (2, 2) mesh of 4 ranks sharing the card,
# a global batch of 4 x 2048 in data shards of 2 sequences: one step's
# forward, backward and the gradient's mean over the data shards
MOE_MESH = dict(ranks=4, model=2, layers=1, batch=4, seq=2048, seed=31,
                timeout=900)
MOE_MESH_LOSS_RTOL = 1e-3
# each rank's bf16 gradient slices against the f32 yardstick's: within
# relative L2 MOE_MESH_GRAD_L2, or within MOE_MESH_FLOOR_FACTOR times one
# device's own bf16 gradient's distance from it where that is larger (at
# random initialisation every leaf's bf16 gradient is 3-8e-2 off the f32
# one: the loss's gradient cancels over the 151,936 logits and the tokens)
MOE_MESH_GRAD_L2 = 2e-2
MOE_MESH_FLOOR_FACTOR = 1.5
# (b) the reduced trainers on the mesh: host 1 (ranks 2, 3) lost at step 2,
# the (2, 2) mesh shrunk to (2, 1), healed at step 4; the arena and PyTree
# loops (no resize) held bit for bit over the first eq_steps. They train
# with sgd(lr): under adamw(3e-4) a parameter whose gradient is near zero
# moves by +-lr whatever its sign, so sums in another order put the mesh's
# and one rank's parameters about 1e-4 apart after a step, and a top-1
# router then flips tokens at a step: reduced llama4-maverick's loss was
# 9.3e-4 off one rank's at step 3 and 1.2e-5 at step 4, with or without
# the host loss (an NVIDIA H100 80GB HBM3 at 700 W; on the CPU, parameters
# 1e-4 apart give such steps, 6.6e-4 and 8.8e-4 for the two configs)
MOE_MESH_TRAIN = dict(archs=("qwen3-moe-235b-a22b",
                             "llama4-maverick-400b-a17b"),
                      batch=4, seq=64, steps=6, loss_step=2, heal_after=2,
                      eq_steps=3, lr=0.5)


MOE_MESH_KERNELS = MESH_KERNELS + ("block_dist",)


def _moe_mesh_cfg(opts: dict):
    """Phase 31(a)'s config: qwen3-moe-235b-a22b at 1 of its 94 layers
    (``opts["reduced"]``: its reduced config in bf16, for a rehearsal on
    the CPU)."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config("qwen3-moe-235b-a22b", reduced=opts.get("reduced",
                                                              False))
    return dataclasses.replace(cfg, n_layers=MOE_MESH["layers"],
                               dtype=opts.get("dtype", "bfloat16"))


def _save_bits(tree, where: Path) -> None:
    """``tree``'s leaves as ``.npy`` files of their raw bits (2-byte floats
    as int16: no numpy bfloat16 is needed to read them) under ``where``,
    with the structure and the dtypes."""
    import pickle
    import numpy as np
    import torch
    from repro_torch.utils.tree import tree_flatten
    leaves, treedef = tree_flatten(tree)
    where.mkdir(parents=True, exist_ok=True)
    dtypes = []
    for i, x in enumerate(leaves):
        dtypes.append(str(x.dtype).removeprefix("torch."))
        bits = x.view(torch.int16) if x.element_size() == 2 \
            and x.is_floating_point() else x
        np.save(where / f"{i}.npy", bits.cpu().numpy())
    (where / "treedef.pkl").write_bytes(pickle.dumps((treedef, dtypes)))


def _load_bits(where: Path, device, slices=None):
    """The tree :func:`_save_bits` wrote, on ``device``: each leaf read
    memory-mapped and, given ``slices`` (``model_slices`` of the tree),
    only its slice placed (``interop.from_numpy_tree``)."""
    import pickle
    import numpy as np
    import torch
    from repro_torch.interop import from_numpy_tree
    from repro_torch.utils.tree import tree_flatten, tree_unflatten
    treedef, dtypes = pickle.loads(Path(where, "treedef.pkl").read_bytes())
    arrays = tree_unflatten(treedef, [
        np.load(Path(where, f"{i}.npy"), mmap_mode="r")
        for i in range(len(dtypes))])
    placed = tree_flatten(from_numpy_tree(arrays, device, slices))[0]
    return tree_unflatten(treedef, [
        x.view(getattr(torch, d)) for x, d in zip(placed, dtypes)])


def _bits_shapes(where: Path):
    """The leaves of a :func:`_save_bits` tree as shape carriers (for
    ``model_slices``), without reading them."""
    import pickle
    import numpy as np
    from repro_torch.utils.tree import tree_unflatten
    treedef, dtypes = pickle.loads(Path(where, "treedef.pkl").read_bytes())
    return tree_unflatten(treedef, [
        np.load(Path(where, f"{i}.npy"), mmap_mode="r")
        for i in range(len(dtypes))])


def _bf16_ulps(got, want) -> tuple[float, int]:
    """The largest ``|got - want|`` in units of bf16's last place at the
    larger magnitude of the two, that magnitude floored at 1/256 of the
    row's largest ``|want|`` (an output that cancels to near zero carries
    the f32 rounding of its terms, which a sum in another order moves by
    many of its own last places), and the count of elements more than
    one last place off at their own magnitude."""
    import torch
    a, b = got.float(), want.float()
    own = torch.maximum(a.abs(), b.abs())
    floor = b.abs().amax(dim=-1, keepdim=True) / 256

    def ulps(scale):
        ulp = torch.exp2(torch.floor(torch.log2(scale.clamp_min(1e-38)))
                         - 7)
        return (a - b).abs() / ulp
    return (float(ulps(torch.maximum(own, floor)).max()),
            int((ulps(own) > 1).sum()))


def _moe_mesh_yardstick(device, opts: dict, work: Path) -> dict:
    """Phase 31(a)'s yardstick on one rank in this process: the weights,
    the batch and the MoE block's input drawn from the seed and written
    under ``work`` for the ranks; the MoE block on each data shard's x
    alone, its output and the (token, expert) pairs each expert kept; then
    :func:`_tp_yardstick`."""
    import torch
    from repro_torch.models import get_model
    from repro_torch.models import layers as L
    from repro_torch.utils.tree import tree_flatten
    cfg = _moe_mesh_cfg(opts)
    ops = get_model(cfg)
    B, S = opts["batch"], opts["seq"]
    cuda = device.type == "cuda"
    gen = torch.Generator(device=device).manual_seed(SEED + MOE_MESH["seed"])
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    params = ops.init_params(gen, cfg, device=device)
    toks = torch.randint(0, cfg.vocab, (B, S + 1), generator=gen,
                         device=device, dtype=torch.int32)
    x = torch.randn((B, S, cfg.d_model), generator=gen,
                    device=device).to(L.torch_dtype(cfg.dtype))
    t0 = time.perf_counter()
    _save_bits(params, work / "params")
    _save_bits({"tokens": toks, "x": x}, work / "inputs")
    out = {"params": sum(t.numel() for t in tree_flatten(params)[0]),
           "save_seconds": time.perf_counter() - t0}
    half = B // 2
    moe = L.layer_params(params, 0)["moe"]
    outs, kept = [], []
    for d in range(2):
        xd = x[d * half:(d + 1) * half]
        o, _ = L.moe_block(xd, moe, cfg)
        outs.append(o)
        n = xd.shape[0] * xd.shape[1]
        kept.append(L.moe_route(xd.reshape(n, -1), moe["router"], cfg,
                                L.moe_capacity(n, cfg))[-1].to(torch.int32))
    _save_bits({"out": torch.stack(outs), "kept": torch.stack(kept)},
               work / "moe")
    del outs, kept, moe, x
    held = {"params": params}
    del params
    out.update(_tp_yardstick(cfg, held, _lm_rows(toks), work))
    return out


def _lm_rows(toks, **extra) -> dict:
    """The batch of token rows ``toks`` (B, S + 1): ``tokens``, ``labels``
    (shifted by one) and any ``extra`` keys (whisper's ``frames``)."""
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:], **extra}


def _tp_yardstick(cfg, held: dict, batch: dict, work: Path) -> dict:
    """The loss and gradient of ``batch`` with ``held["params"]`` on one
    rank, the batch run as 2 microbatches (the data shards' contiguous
    halves: the mean of their losses and gradients), in the model's dtype
    and again with the same weights in f32. The f32 gradient (written
    under ``work`` in the leaves' dtypes) stands in for the exact one: one
    device's bf16 gradient is some way off it on every leaf
    (``bf16_floor``), and the ranks' bf16 gradient is held to it with
    that floor beside ``MOE_MESH_GRAD_L2``. The weights are taken out of
    ``held``, so the model-dtype copy goes when the f32 one is made."""
    import dataclasses
    import torch
    from repro_torch.models import get_model
    from repro_torch.utils.tree import (flatten_with_path, keystr, tree_map,
                                        tree_unflatten)
    ops = get_model(cfg)
    cuda = next(iter(batch.values())).is_cuda
    params = held.pop("params")
    out = {}
    t0 = time.perf_counter()
    loss, grads, treedef = _two_halves(ops, cfg, params, batch)
    out["loss_and_grad_seconds"] = time.perf_counter() - t0
    out["loss"], out["shard_losses"] = loss
    # the exact gradient's stand-in: the same weights, batch and halves in
    # f32 (one device's bf16 gradient is this far off it: the floor the
    # ranks' bf16 gradient is held to beside MOE_MESH_GRAD_L2)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params = tree_map(lambda t: t.float(), params)
    t0 = time.perf_counter()
    loss32, exact, _ = _two_halves(get_model(cfg32), cfg32, params, batch)
    out["f32_loss_and_grad_seconds"] = time.perf_counter() - t0
    out["f32_loss"] = loss32[0]
    del params
    paths = [keystr(q) for q, _ in flatten_with_path(
        tree_unflatten(treedef, grads))[0]]
    out["bf16_floor"] = {q: _rel_l2(g, e) for q, g, e in
                         zip(paths, grads, exact)}
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9 if cuda else 0.0
    exact = [e.to(g.dtype) for g, e in zip(grads, exact)]
    del grads
    _save_bits(tree_unflatten(treedef, exact), work / "grads")
    del exact
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return out


def _two_halves(ops, cfg, params, batch: dict):
    """``loss_and_grad`` of ``batch`` run as its 2 contiguous halves (the
    data shards): ((the mean loss, the halves' losses), the mean
    gradient's leaves, added in f32 and stored in the leaves' dtypes, the
    tree's structure)."""
    import torch
    from repro_torch.training.step import loss_and_grad
    from repro_torch.utils.tree import tree_flatten
    half = next(iter(batch.values())).shape[0] // 2
    losses, acc = [], None
    for d in range(2):
        sl = slice(d * half, (d + 1) * half)
        loss, g = loss_and_grad(ops, cfg, params,
                                {k: v[sl] for k, v in batch.items()})
        losses.append(float(loss))
        g, treedef = tree_flatten(g)
        if acc is None:
            dtypes = [t.dtype for t in g]
            acc = [t.float() for t in g]
        else:
            for a, t in zip(acc, g):
                a.add_(t.float())
        del g
    if next(iter(batch.values())).is_cuda:
        torch.cuda.synchronize()
    return ((sum(losses) / 2, losses),
            [a.div_(2).to(dt) for a, dt in zip(acc, dtypes)], treedef)


def _moe_mesh_full(device, opts: dict) -> dict:
    """Phase 31(a) on one rank: this rank's model slices placed from the
    yardstick's files (``model_slices``, ``interop.from_numpy_tree``: no
    rank reads or holds the whole model), the MoE block on its data
    shard's x, then :func:`_tp_step`."""
    import torch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import layers as L
    from repro_torch.sharding.partition import make_dist_ctx, model_slices
    from repro_torch.utils.tree import tree_flatten
    work = Path(opts["work"])
    cfg = _moe_mesh_cfg(opts)
    mesh = make_host_mesh(model=MOE_MESH["model"])
    ctx = make_dist_ctx(mesh)
    d, m = mesh.axis_position("data"), mesh.axis_position("model")
    slices = model_slices(_bits_shapes(work / "params"), ctx)
    t0 = time.perf_counter()
    params = _load_bits(work / "params", device, slices)
    out = {"place_seconds": time.perf_counter() - t0,
           "held_values": sum(t.numel() for t in tree_flatten(params)[0])}
    inputs = _load_bits(work / "inputs", device)
    half = opts["batch"] // 2
    rows = {k: v.cpu().numpy() for k, v in _lm_rows(inputs["tokens"]).items()}
    x = inputs["x"][d * half:(d + 1) * half].contiguous()
    del inputs
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()

    # the MoE block alone on the data shard's x
    yard = _load_bits(work / "moe", device)
    moe = L.layer_params(params, 0)["moe"]
    E_l = cfg.n_experts // MOE_MESH["model"]
    with torch.no_grad():
        o, _ = L.moe_block(x, moe, cfg, ctx)
        n = x.shape[0] * x.shape[1]
        kept = L.moe_route(x.reshape(n, -1), moe["router"], cfg,
                           L.moe_capacity(n, cfg), E_local=E_l,
                           e_offset=m * E_l)[-1].to(torch.int32)
    want_kept = yard["kept"][d][m * E_l:(m + 1) * E_l]
    out["moe_kept_equal"] = bool(torch.equal(kept, want_kept))
    out["moe_out_ulps"], out["moe_out_own_ulp_misses"] = _bf16_ulps(
        o, yard["out"][d])
    check(out["moe_kept_equal"], f"rank {mesh.position()}: the MoE block's "
          f"kept (token, expert) pairs differ from the yardstick's")
    check(out["moe_out_ulps"] <= 1.0, f"rank {mesh.position()}: the MoE "
          f"block is {out['moe_out_ulps']} bf16 ulps off the yardstick's")
    del yard, o, kept, want_kept, moe, x
    out.update(_tp_step(device, cfg, ctx, params, slices, rows, work))
    return out


def _shared_ranges(shapes, ctx) -> list:
    """For each leaf of ``shapes``, in leaf order, ``(dim, places,
    width)``: the ranges of the leaf along ``dim`` that more than one model
    position holds (a Mamba2 ``in_proj``'s B and C columns, which every
    position holds; a kv head shared by the positions whose query heads
    read it) laid end to end make a buffer ``width`` wide (0: none), and
    ``places`` puts each such range of this rank's cut leaf there, ``(lo,
    hi, at)`` (its own indices ``lo:hi`` at ``at:at + hi - lo``). Each
    rank's gradient there is its own heads' part; the sum over the line of
    the buffers, each zero where its rank holds nothing, is the
    gradient."""
    from repro_torch.sharding.partition import model_slices
    from repro_torch.utils.tree import tree_flatten
    per = [tree_flatten(model_slices(shapes, ctx, p))[0]
           for p in range(ctx.tp_size)]
    mine = per[ctx.mesh.axis_position(ctx.tp)]
    out = []
    for i, s in enumerate(mine):
        held = [r for p in per for r in (p[i].ranges if p[i] else ())]
        at, width = {}, 0
        for lo, hi in sorted({r for r in held if held.count(r) > 1}):
            at[(lo, hi)], width = width, width + hi - lo
        places, off = [], 0
        for lo, hi in (s.ranges if s else ()):
            if (lo, hi) in at:
                places.append((off, off + hi - lo, at[(lo, hi)]))
            off += hi - lo
        out.append((s[0] if s else None, places, width))
    return out


def _tp_step(device, cfg, ctx, params, slices, rows: dict, work: Path
             ) -> dict:
    """One step of the TP forward on a rank: the forward and backward of
    its data shard of ``rows`` (the global batch's host arrays) on its
    model slices ``params`` (let go here), then the gradient's mean over
    the data line, each slice held against the yardstick's under
    ``work`` (:func:`_tp_yardstick`); where more than one rank of the model
    line holds a range (:func:`_shared_ranges`) the sum of the mean over
    the ranks that hold it."""
    import torch
    from repro_torch.data.pipeline import slice_batch
    from repro_torch.distributed import collectives
    from repro_torch.distributed.collectives import MeshComm, model_axis
    from repro_torch.interop import from_numpy_tree
    from repro_torch.models import get_model
    from repro_torch.utils.tree import (flatten_with_path, keystr,
                                        tree_flatten, tree_unflatten)
    ops = get_model(cfg)
    mesh = ctx.mesh
    cuda = device.type == "cuda"
    batch = dict(slice_batch(rows, mesh, device, True))
    out = {}
    flat, treedef = tree_flatten(params)
    leaves = [t.detach().requires_grad_(True) for t in flat]
    del flat, params

    def fwd_bwd():
        with torch.enable_grad():
            loss = ops.train_loss(tree_unflatten(treedef, leaves), batch,
                                  cfg, ctx=ctx)
            # a rank without query heads reads no kv head: its empty
            # slices of wk, wv, bk and bv get a zero gradient
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            return loss, [torch.zeros_like(x) if g is None else g
                          for x, g in zip(leaves, grads)]
    # an untimed first step: the first call's library set-up took 8 s of
    # phase 31's yardstick's 9.5 s (its second call, in f32, 1.4 s)
    fwd_bwd()
    collectives.reset_stats()
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, grads = fwd_bwd()
    if cuda:
        torch.cuda.synchronize()
    out["fwd_bwd_seconds"] = time.perf_counter() - t0
    del leaves
    data = MeshComm(mesh.axis_mesh("data"))
    line = model_axis(ctx).comm
    loss_mean = data.all_reduce(loss.detach().reshape(1).clone(),
                                name="data_loss_mean")[0] / data.n
    # leaf by leaf: the data line's mean (gathered as raw bytes, added in
    # f32), held against the yardstick's same slice, then let go
    paths = [keystr(q) for q, _ in flatten_with_path(
        tree_unflatten(treedef, grads))[0]]
    yard = tree_flatten(_bits_shapes(work / "grads"))[0]
    cuts = tree_flatten(slices)[0]
    shared = _shared_ranges(_bits_shapes(work / "params"), ctx)
    worst, worst_leaf, t_mean, by_leaf = 0.0, "", 0.0, {}
    for i, path in enumerate(paths):
        g, grads[i] = grads[i], None
        if cuda:
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        if g.numel():
            raw = data.all_gather(g.contiguous().view(-1).view(torch.uint8),
                                  name="data_grad_mean")
            parts = raw.view(data.n, -1).view(g.dtype)
            acc = parts[0].float()
            for k in range(1, data.n):
                acc.add_(parts[k].float())
            acc = acc.div_(data.n).view(g.shape)
            del raw, parts
        else:
            # an empty slice (a rank without query heads): every rank of
            # its data line holds the same, so none gathers it
            acc = g.float()
        dim, places, width = shared[i]
        if width:
            # each rank puts its shared ranges into their places in one
            # buffer of every shared range; the line sums the buffers
            shape = list(acc.shape)
            shape[dim] = width
            buf = torch.zeros(shape, dtype=acc.dtype, device=acc.device)
            for lo, hi, at in places:
                buf.narrow(dim, at, hi - lo).copy_(
                    acc.narrow(dim, lo, hi - lo))
            tot = line.summed(buf, "model_shared_grad")
            for lo, hi, at in places:
                acc.narrow(dim, lo, hi - lo).copy_(
                    tot.narrow(dim, at, hi - lo))
            del buf, tot
        if cuda:
            torch.cuda.synchronize()
        t_mean += time.perf_counter() - t1
        w = from_numpy_tree(yard[i], device, cuts[i])
        w = w.view(g.dtype) if w.dtype != g.dtype else w
        check(bool(torch.isfinite(acc).all()), f"rank {mesh.position()}: "
              f"non-finite gradient at {path}")
        r = _rel_l2(acc.reshape(-1), w.reshape(-1))
        by_leaf[path] = r
        if r > worst:
            worst, worst_leaf = r, path
        del g, acc, w
    out["grad_mean_seconds"] = t_mean
    out["step_seconds"] = out["fwd_bwd_seconds"] + t_mean
    out["peak_gb"] = (torch.cuda.max_memory_allocated() / 1e9
                      if cuda else 0.0)
    out["loss"] = float(loss_mean)
    out["shard_loss"] = float(loss.detach())
    out["collectives"] = collectives.seconds_and_bytes()
    out["grad_rel_l2"] = worst
    out["grad_worst_leaf"] = worst_leaf
    out["grad_rel_l2_by_leaf"] = by_leaf
    return out


def _moe_mesh_train(device, opts: dict, name: str) -> dict:
    """Phase 31(b) on one rank for one reduced config: the PyTree and the
    arena loops on the (2, 2) mesh through host 1's loss without a resize
    (``eq_steps`` steps: losses, checkpoint and parameter spans bit for
    bit), then the elastic arena loop through the shrink to (2, 1) and the
    heal (its launch counts), and each fabric kernel of that path against
    its plain version on this rank's span (:func:`_hold_mesh_rank`)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.arena import pack_arena
    from repro_torch.data import ShardedLMDataset
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim import sgd
    from repro_torch.sharding.partition import make_dist_ctx
    from repro_torch.training import ArenaTrainState
    T = MOE_MESH_TRAIN
    cfg = get_config(name, reduced=True)
    mesh = make_host_mesh(model=MOE_MESH["model"])
    ctx = make_dist_ctx(mesh)
    params = _load_mesh_params(str(Path(opts["work"]) / name))
    sched = [(T["loss_step"], "host", 1)]

    def data():
        return iter(ShardedLMDataset(cfg, T["batch"], T["seq"], seed=0,
                                     device=device, ctx=ctx))

    runs = {}
    for arena in (False, True):
        lp = _mesh_loop(cfg, device, ctx=ctx, arena=arena, elastic=False,
                        optimizer=sgd(T["lr"]))
        lp.loop_cfg.fail_schedule = sched
        lp.loop_cfg.heal_after = T["heal_after"]
        st = lp.run(lp.init_state(params=params), data(), T["eq_steps"])
        runs[arena] = (lp, st)
    (lt, st), (la, sa) = runs[False], runs[True]
    lay = la.controller.arena_layout
    w0, w1 = lay.span(mesh.position())
    check([x["loss"] for x in la.metrics] == [x["loss"] for x in lt.metrics],
          f"{name}: arena losses {[x['loss'] for x in la.metrics]}, PyTree "
          f"{[x['loss'] for x in lt.metrics]}")
    check(torch.equal(la.controller._ckpt_arena, lt.controller._ckpt_arena)
          and torch.equal(sa.arena, pack_arena(st.params, lay)[w0:w1]),
          f"{name}: the arena and PyTree spans differ on the mesh")
    out = {"bit_equal_losses": [x["loss"] for x in la.metrics],
           "eq_failures": [f["tier_counts"] for x in la.metrics
                           for f in x.get("failures", [])]}
    del runs, lt, st, la, sa
    gc.collect()

    loop = _mesh_loop(cfg, device, ctx=ctx, optimizer=sgd(T["lr"]))
    loop.loop_cfg.fail_schedule = sched
    loop.loop_cfg.heal_after = T["heal_after"]
    state = loop.init_state(params=params)
    check(isinstance(state, ArenaTrainState), f"{name}: not arena-resident")
    _build.reset_launches()
    t0 = time.perf_counter()
    state = loop.run(state, data(), T["steps"])
    if device.type == "cuda":
        torch.cuda.synchronize()
    out["run_seconds"] = time.perf_counter() - t0
    out["launches"] = dict(_build.LAUNCHES)
    m = loop.metrics
    out["losses"] = [x["loss"] for x in m]
    out["idle_steps"] = [x["step"] for x in m if x.get("idle")]
    out["shards"] = [MOE_MESH["ranks"]] + [x["mesh_resize"]["shards"]
                                          for x in m if "mesh_resize" in x]
    out["failures"] = [f for x in m for f in x.get("failures", [])]
    fab, ctl = loop.controller.fabric, loop.controller
    step = fab.last_maintained_step
    fab.maintain(step, state.arena, ckpt_values=ctl._ckpt_arena, force=True)
    out["holds"] = _hold_mesh_rank(loop, state, fab.last_scores.clone())
    return out


def _moe_mesh_rank_body(rank: int, opts: dict) -> dict:
    """One rank of phase 31 (see :func:`phase_moe_mesh`)."""
    import torch
    device = torch.device(opts["device"])
    cuda = device.type == "cuda"
    out = {"rank": rank}
    out["full"] = _moe_mesh_full(device, opts)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    out["train"] = {name: _moe_mesh_train(device, opts, name)
                    for name in MOE_MESH_TRAIN["archs"]}
    out["host_peak_gb"] = _host_peak_gb()
    return out


def _moe_mesh_rank(rank: int, world: int, rdv: str, out_dir: str,
                   opts: dict) -> None:
    """Spawned rank of phase 31, 32, 33, 34 or 35 (``opts["phase"]``):
    joins the gloo group, runs :func:`_moe_mesh_rank_body`,
    :func:`_ssm_mesh_rank_body`, :func:`_serve_mesh_rank_body` or
    :func:`_launch_rank_body`, writes its report."""
    import datetime
    import torch
    import torch.distributed as dist
    if opts["device"] == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo", init_method=f"file://{rdv}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=MOE_MESH["timeout"]))
    try:
        body = {32: _ssm_mesh_rank_body, 33: _serve_mesh_rank_body,
                34: _launch_rank_body, 35: _launch_rank_body}.get(
                    opts.get("phase"), _moe_mesh_rank_body)
        out = body(rank, opts)
        Path(out_dir, f"rank{rank}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()


def _mesh_ranks(work: Path, opts: dict, phase: str,
                world: int = MOE_MESH["ranks"]) -> tuple[list, float]:
    """Spawn phase 31's, 32's, 33's or 34's 4 ranks, or phase 35's
    ``world`` (:func:`_moe_mesh_rank`), on the card, join them within
    ``MOE_MESH["timeout"]`` seconds (stopping any left), and return their
    reports in rank order and the seconds from the spawn to the join."""
    import torch.multiprocessing as mp
    rdv = work / "rendezvous"
    if rdv.exists():
        rdv.unlink()
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    t0 = time.perf_counter()
    procs = mp.start_processes(
        _moe_mesh_rank, args=(world, str(rdv), str(work), opts),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + MOE_MESH["timeout"]
    try:
        while not procs.join(timeout=5):
            if time.monotonic() > deadline:
                raise AssertionError(f"phase {phase}: the ranks did not "
                                     f"finish in {MOE_MESH['timeout']} s")
    finally:
        for p in procs.processes:
            if p.is_alive():
                p.terminate()
                p.join(30)
    wall = time.perf_counter() - t0
    return [json.loads((work / f"rank{r}.json").read_text())
            for r in range(world)], wall


def _moe_mesh_one_rank(device, name: str, work: Path) -> list:
    """Phase 31(b)'s yardstick: ``name``'s reduced config on one rank with
    ``microbatch=2`` (the data shards' halves), the same weights (written
    under ``work`` for the ranks), batches and schedule; its losses."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.data import ShardedLMDataset
    from repro_torch.optim import sgd
    T = MOE_MESH_TRAIN
    cfg = get_config(name, reduced=True)
    params = _save_mesh_params(device, {"seed": SEED + MOE_MESH["seed"]},
                               work / name, cfg)
    loop = _mesh_loop(dataclasses.replace(cfg, microbatch=2), device,
                      optimizer=sgd(T["lr"]))
    loop.loop_cfg.fail_schedule = [(T["loss_step"], "host", 1)]
    loop.loop_cfg.heal_after = T["heal_after"]
    loop.run(loop.init_state(params=params), iter(ShardedLMDataset(
        cfg, T["batch"], T["seq"], seed=0, device=device)), T["steps"])
    return [x["loss"] for x in loop.metrics]


def phase_moe_mesh(device, launches: dict, card: str, opts=None) -> dict:
    """Phase 31: the tensor- and expert-parallel forward on a (2, 2) mesh
    of 4 gloo ranks sharing the one card.

    (a) qwen3-moe-235b-a22b at full width (d 4096, GQA 64/4 of 128, 128
    experts top-8 of d_ff 1536, the untied 151,936-row head, bf16, the
    router f32) with 1 of its 94 layers: each rank places only its slices
    (32 of the query heads and 2 of the kv heads, 64 experts, 75,968 rows
    of the embedding and of the head) from files this process wrote, and
    runs the MoE block on its data shard's x, then one step's forward and
    backward on its data shard (2 x 2048 tokens) and the gradient's mean
    over the data line. Yardstick: the same weights and batch on one rank
    in this process, run as 2 microbatches (the data shards' halves), then
    freed; the same in f32 as the exact gradient's stand-in. Held: the
    ranks' loss within rtol 1e-3 of the yardstick's, each rank's gradient
    slices within relative L2 2e-2 of the f32 yardstick's same slices, or
    within 1.5 times one device's bf16 distance from it where that is
    larger (``MOE_MESH_GRAD_L2``), the MoE
    block's kept (token, expert) pairs identical and its output within one
    bf16 ulp (at the larger of the element's magnitude and 1/256 of its
    row's largest, :func:`_bf16_ulps`).

    (b) reduced qwen3-moe and reduced llama4-maverick (top-1, a shared
    expert, an MoE layer every 2) trained with sgd(0.5) (``MOE_MESH_TRAIN``
    says why not adamw) on the mesh for 6 steps, host 1
    lost at step 2 ((2, 2) -> (2, 1)), healed at step 4. Held: the arena
    and PyTree loops bit-equal through the loss (no resize, 3 steps); the
    ranks' losses equal and within ``MESH_LOSS_RTOL`` of one rank with
    ``microbatch=2``; shards 4, 2, 4; arena_maintain, arena_scatter,
    parity_xor and block_dist launched on every rank, masked_restore on
    every rank whose span held a lost block (``launches["moe_mesh"]``, one
    count a rank, both configs' elastic runs); each kernel of the path
    against its plain version on every rank's span.

    Reported with the card: each rank's peak device memory and their sum,
    the step's seconds, each collective's calls, bytes, seconds and staged
    bytes. A failed rank or collective fails the phase."""
    import torch
    t_phase = time.perf_counter()
    work = ROOT / "build" / f"moe_mesh_{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    opts = {"device": device.type, "work": str(work),
            "batch": MOE_MESH["batch"], "seq": MOE_MESH["seq"],
            **(opts or {})}
    try:
        yard = _moe_mesh_yardstick(device, opts, work)
        log(f"phase 31(a): the one-rank yardstick, {json.dumps(yard)}")
        one = {name: _moe_mesh_one_rank(device, name, work)
               for name in MOE_MESH_TRAIN["archs"]}
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        ranks, wall = _mesh_ranks(work, opts, "31")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    full = [r["full"] for r in ranks]
    log(f"phase 31(a): each rank's gradient slices against the yardstick's "
        f"(relative L2), {json.dumps([f['grad_rel_l2_by_leaf'] for f in full])}")
    for r, f in zip(ranks, full):
        rel = abs(f["loss"] - yard["loss"]) / abs(yard["loss"])
        check(rel <= MOE_MESH_LOSS_RTOL and f["loss"] == full[0]["loss"],
              f"phase 31(a) rank {r['rank']}: loss {f['loss']}, yardstick "
              f"{yard['loss']}")
        for leaf, err in f["grad_rel_l2_by_leaf"].items():
            floor = yard["bf16_floor"][leaf]
            check(err <= max(MOE_MESH_GRAD_L2, MOE_MESH_FLOOR_FACTOR * floor),
                  f"phase 31(a) rank {r['rank']}: gradient slice {leaf} off "
                  f"the f32 yardstick by relative L2 {err}, one device's "
                  f"bf16 gradient by {floor}")
    moe_launches = [{} for _ in ranks]
    for name in MOE_MESH_TRAIN["archs"]:
        tr = [r["train"][name] for r in ranks]
        rel = max(abs(a - b) / abs(b)
                  for a, b in zip(tr[0]["losses"], one[name]))
        check(rel <= MESH_LOSS_RTOL and all(
            t["losses"] == tr[0]["losses"] for t in tr),
              f"phase 31(b) {name}: mesh losses "
              f"{[t['losses'] for t in tr]}, one rank {one[name]}")
        fail, = tr[0]["failures"]
        check(fail["tier_counts"]["PEER_REPLICA"] == fail["lost_blocks"] > 0
              and fail["applied_sq"] == 0.0, f"phase 31(b) {name}: "
              f"recovery {fail}")
        for r, t in zip(ranks, tr):
            check(t["shards"] == [4, 2, 4], f"phase 31(b) {name} rank "
                  f"{r['rank']}: shards {t['shards']}")
            for k, v in t["launches"].items():
                moe_launches[r["rank"]][k] = \
                    moe_launches[r["rank"]].get(k, 0) + v
    for r, cnt in zip(ranks, moe_launches):
        for k in MOE_MESH_KERNELS:
            check(cnt.get(k, 0) > 0, f"{k} was not launched on rank "
                  f"{r['rank']} of the phase 31 mesh path")
        lost = any(r["train"][n]["holds"]["lost_in_span"]
                   for n in MOE_MESH_TRAIN["archs"])
        check(cnt.get("masked_restore", 0) > 0 or not lost
              or not MOE_MESH_KERNELS,
              f"masked_restore was not launched on rank {r['rank']}, whose "
              f"span held a lost block")
    launches["moe_mesh"] = moe_launches
    peaks = [f["peak_gb"] for f in full]
    out = {"yardstick": yard, "one_rank_losses": one,
           "rank_peak_gb": peaks, "summed_peak_gb": sum(peaks),
           "host_peak_gb": [r["host_peak_gb"] for r in ranks],
           "loss": full[0]["loss"],
           "loss_rel_diff": abs(full[0]["loss"] - yard["loss"])
           / abs(yard["loss"]),
           "grad_rel_l2": [f["grad_rel_l2"] for f in full],
           "grad_worst_leaf": [f["grad_worst_leaf"] for f in full],
           "grad_over_floor": [max(err / max(yard["bf16_floor"][k], 1e-30)
                                   for k, err in
                                   f["grad_rel_l2_by_leaf"].items())
                               for f in full],
           "moe_out_ulps": [f["moe_out_ulps"] for f in full],
           "moe_out_own_ulp_misses": [f["moe_out_own_ulp_misses"]
                                      for f in full],
           "step_seconds": [f["step_seconds"] for f in full],
           "fwd_bwd_seconds": [f["fwd_bwd_seconds"] for f in full],
           "grad_mean_seconds": [f["grad_mean_seconds"] for f in full],
           "place_seconds": [f["place_seconds"] for f in full],
           "held_values": [f["held_values"] for f in full],
           "collectives": [f["collectives"] for f in full],
           "train": {name: {"losses": ranks[0]["train"][name]["losses"],
                            "bit_equal_losses":
                                ranks[0]["train"][name]["bit_equal_losses"],
                            "run_seconds": [r["train"][name]["run_seconds"]
                                            for r in ranks],
                            "holds": [r["train"][name]["holds"]
                                      for r in ranks]}
                     for name in MOE_MESH_TRAIN["archs"]},
           "spawn_to_join_seconds": wall, "card": card}
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 31: the tensor- and expert-parallel forward on a (2, 2) "
        f"mesh, {card}: {json.dumps(out)}")
    return out


def moe_mesh_only(device, card: str) -> int:
    """``--moe-mesh``: phase 31 alone. Its last line says that it is this
    partial run, never the full run's ``{"ok": true, ...}``."""
    import torch
    launches = {}
    out = phase_moe_mesh(device, launches, card)
    log(json.dumps({"launches": launches["moe_mesh"]}))
    log(card)
    log(json.dumps({"moe_mesh_only": True, "seconds": out["seconds"],
                    "device": {"platform": "gpu",
                               "kind": torch.cuda.get_device_name(0),
                               "count": torch.cuda.device_count()}}))
    return 0


# ---------------------------------------------------------------------------
# phase 32: tensor parallelism for the ssm, hybrid and encoder-decoder
# families on a mesh
# ---------------------------------------------------------------------------

# (a) each config at full width on phase 31's (2, 2) mesh of 4 ranks, bf16,
# a global batch of 4 sequences in data shards of 2, microbatch 1, one
# step's forward, backward and data mean, as 31(a): zamba2-1.2b's first
# segment (6 of its 38 Mamba2 layers and one application of the shared
# block) on 2,048 tokens; whisper-medium with 2 + 2 of its 24 + 24 layers
# on 1,500 frames and 448 tokens (its 51,865-row vocab splits over no model
# axis: the embedding, the head and the loss whole on every rank)
SSM_MESH = dict(archs=(("zamba2-1.2b", dict(n_layers=6), 2048),
                       ("whisper-medium", dict(n_layers=2, enc_layers=2),
                        448)),
                batch=4, seed=32)
# (b) the reduced trainers through 31(b)'s host loss and heal
SSM_MESH_TRAIN = ("mamba2-370m", "zamba2-1.2b", "whisper-medium")


def _ssm_mesh_cfg(name: str, cut: dict, opts: dict):
    """Phase 32(a)'s config of ``name``, its depth ``cut`` (``opts["reduced"]``:
    the reduced config, for a rehearsal on the CPU), bf16 unless
    ``opts["dtype"]``, microbatch 1."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(name, reduced=opts.get("reduced", False))
    return dataclasses.replace(cfg, dtype=opts.get("dtype", "bfloat16"),
                               microbatch=1, **cut)


def _ssm_mesh_yardstick(device, opts: dict, work: Path) -> dict:
    """Phase 32(a)'s yardsticks on one rank in this process: each config's
    weights and batch (whisper's frames too) drawn from the seed and
    written under ``work / name`` for the ranks, then
    :func:`_tp_yardstick`."""
    import torch
    from repro_torch.models import get_model
    from repro_torch.utils.tree import tree_flatten
    out = {}
    for k, (name, cut, seq) in enumerate(SSM_MESH["archs"]):
        cfg = _ssm_mesh_cfg(name, cut, opts)
        B, S = opts["batch"], opts.get("seq", seq)
        gen = torch.Generator(device=device).manual_seed(
            SEED + SSM_MESH["seed"] + k)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        params = get_model(cfg).init_params(gen, cfg, device=device)
        toks = torch.randint(0, cfg.vocab, (B, S + 1), generator=gen,
                             device=device, dtype=torch.int32)
        extra = {}
        if cfg.family == "audio":
            extra["frames"] = torch.randn((B, cfg.enc_seq, cfg.d_model),
                                          generator=gen, device=device)
        t0 = time.perf_counter()
        _save_bits(params, work / name / "params")
        _save_bits({"tokens": toks, **extra}, work / name / "inputs")
        r = {"params": sum(t.numel() for t in tree_flatten(params)[0]),
             "save_seconds": time.perf_counter() - t0}
        held = {"params": params}
        del params
        r.update(_tp_yardstick(cfg, held, _lm_rows(toks, **extra),
                               work / name))
        out[name] = r
    return out


def _ssm_mesh_full(device, opts: dict) -> dict:
    """Phase 32(a) on one rank, each config in turn: its model slices
    placed from the yardstick's files, then :func:`_tp_step`."""
    import torch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding.partition import make_dist_ctx, model_slices
    from repro_torch.utils.tree import tree_flatten
    mesh = make_host_mesh(model=MOE_MESH["model"])
    ctx = make_dist_ctx(mesh)
    out = {}
    for name, cut, _ in SSM_MESH["archs"]:
        cfg = _ssm_mesh_cfg(name, cut, opts)
        work = Path(opts["work"]) / "full" / name
        slices = model_slices(_bits_shapes(work / "params"), ctx)
        t0 = time.perf_counter()
        params = _load_bits(work / "params", device, slices)
        r = {"place_seconds": time.perf_counter() - t0,
             "held_values": sum(t.numel()
                                for t in tree_flatten(params)[0])}
        inputs = _load_bits(work / "inputs", device)
        rows = {k: v.cpu().numpy() for k, v in
                _lm_rows(inputs.pop("tokens"), **inputs).items()}
        del inputs
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        r.update(_tp_step(device, cfg, ctx, params, slices, rows, work))
        del params
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        out[name] = r
    return out


def _ssm_mesh_rank_body(rank: int, opts: dict) -> dict:
    """One rank of phase 32 (see :func:`phase_ssm_mesh`)."""
    import torch
    device = torch.device(opts["device"])
    out = {"rank": rank, "full": _ssm_mesh_full(device, opts)}
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    out["train"] = {name: _moe_mesh_train(device, opts, name)
                    for name in SSM_MESH_TRAIN}
    out["host_peak_gb"] = _host_peak_gb()
    return out


def phase_ssm_mesh(device, launches: dict, card: str, opts=None) -> dict:
    """Phase 32: tensor parallelism for the ssm, hybrid and
    encoder-decoder families on phase 31's (2, 2) mesh of 4 gloo ranks
    sharing the one card.

    (a) ``SSM_MESH``: zamba2-1.2b at full width (d 2048; Mamba2 layers of
    64 SSD heads, a 2,048 x 8,384 ``in_proj``; the shared block's GQA
    32/32 heads and d_ff 8192; the untied 32,000-row head; bf16) at its
    first segment, each rank holding 32 SSD heads (their z, x and dt
    columns and every B and C column), 16 heads, half of d_ff and of the
    vocab; then whisper-medium at full width (d 1024, 16 heads, d_ff
    4096) with 2 + 2 layers, its 51,865-row vocab whole on every rank.
    Each rank places its slices from files this process wrote, runs one
    step's forward and backward on its data shard and the gradient's mean
    over the data line (a range every rank holds summed over the model
    line). Yardstick: the same weights and batch on one rank in this
    process as 2 microbatches, and again in f32. Held as 31(a): the ranks'
    loss within ``MOE_MESH_LOSS_RTOL`` of the yardstick's and the same on
    every rank, each gradient slice within ``MOE_MESH_GRAD_L2`` of the f32
    yardstick's, or ``MOE_MESH_FLOOR_FACTOR`` times one device's bf16
    distance from it where that is larger.

    (b) reduced mamba2-370m, zamba2-1.2b and whisper-medium trained as
    31(b) (sgd(0.5), host 1 lost at step 2, healed at step 4): the arena
    and PyTree loops bit-equal through the loss, the ranks' losses equal
    and within ``MESH_LOSS_RTOL`` of one rank with ``microbatch=2``,
    shards 4, 2, 4, the fabric kernels launched on every rank
    (``launches["ssm_mesh"]``, one count a rank) and held against their
    plain versions on every rank's span.

    Reported with the card: each rank's peak device memory, the step's
    seconds and each collective's calls, bytes and seconds."""
    import torch
    t_phase = time.perf_counter()
    work = ROOT / "build" / f"ssm_mesh_{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    opts = {"device": device.type, "work": str(work), "phase": 32,
            "batch": SSM_MESH["batch"], **(opts or {})}
    try:
        yard = _ssm_mesh_yardstick(device, opts, work / "full")
        log(f"phase 32(a): the one-rank yardsticks, {json.dumps(yard)}")
        one = {name: _moe_mesh_one_rank(device, name, work)
               for name in SSM_MESH_TRAIN}
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        ranks, wall = _mesh_ranks(work, opts, "32")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    full = {name: [r["full"][name] for r in ranks]
            for name, _, _ in SSM_MESH["archs"]}
    log(f"phase 32(a): each rank's gradient slices against the yardstick's "
        f"(relative L2), {json.dumps({n: [f['grad_rel_l2_by_leaf'] for f in fs] for n, fs in full.items()})}")
    for name, fs in full.items():
        y = yard[name]
        for r, f in zip(ranks, fs):
            rel = abs(f["loss"] - y["loss"]) / abs(y["loss"])
            check(rel <= MOE_MESH_LOSS_RTOL and f["loss"] == fs[0]["loss"],
                  f"phase 32(a) {name} rank {r['rank']}: loss {f['loss']}, "
                  f"yardstick {y['loss']}")
            for leaf, err in f["grad_rel_l2_by_leaf"].items():
                floor = y["bf16_floor"][leaf]
                check(err <= max(MOE_MESH_GRAD_L2,
                                 MOE_MESH_FLOOR_FACTOR * floor),
                      f"phase 32(a) {name} rank {r['rank']}: gradient slice "
                      f"{leaf} off the f32 yardstick by relative L2 {err}, "
                      f"one device's bf16 gradient by {floor}")
    counts = [{} for _ in ranks]
    for name in SSM_MESH_TRAIN:
        tr = [r["train"][name] for r in ranks]
        rel = max(abs(a - b) / abs(b)
                  for a, b in zip(tr[0]["losses"], one[name]))
        check(rel <= MESH_LOSS_RTOL and all(
            t["losses"] == tr[0]["losses"] for t in tr),
              f"phase 32(b) {name}: mesh losses "
              f"{[t['losses'] for t in tr]}, one rank {one[name]}")
        fail, = tr[0]["failures"]
        check(fail["tier_counts"]["PEER_REPLICA"] == fail["lost_blocks"] > 0
              and fail["applied_sq"] == 0.0, f"phase 32(b) {name}: "
              f"recovery {fail}")
        for r, t in zip(ranks, tr):
            check(t["shards"] == [4, 2, 4], f"phase 32(b) {name} rank "
                  f"{r['rank']}: shards {t['shards']}")
            for k, v in t["launches"].items():
                counts[r["rank"]][k] = counts[r["rank"]].get(k, 0) + v
    for r, cnt in zip(ranks, counts):
        for k in MOE_MESH_KERNELS:
            check(cnt.get(k, 0) > 0, f"{k} was not launched on rank "
                  f"{r['rank']} of the phase 32 mesh path")
        lost = any(r["train"][n]["holds"]["lost_in_span"]
                   for n in SSM_MESH_TRAIN)
        check(cnt.get("masked_restore", 0) > 0 or not lost
              or not MOE_MESH_KERNELS,
              f"masked_restore was not launched on rank {r['rank']}, whose "
              f"span held a lost block")
    launches["ssm_mesh"] = counts
    out = {"yardstick": yard, "one_rank_losses": one,
           "host_peak_gb": [r["host_peak_gb"] for r in ranks],
           "full": {name: {
               "loss": fs[0]["loss"],
               "loss_rel_diff": abs(fs[0]["loss"] - yard[name]["loss"])
               / abs(yard[name]["loss"]),
               "rank_peak_gb": [f["peak_gb"] for f in fs],
               "grad_rel_l2": [f["grad_rel_l2"] for f in fs],
               "grad_worst_leaf": [f["grad_worst_leaf"] for f in fs],
               "grad_over_floor": [max(
                   err / max(yard[name]["bf16_floor"][k], 1e-30)
                   for k, err in f["grad_rel_l2_by_leaf"].items())
                   for f in fs],
               **{k: [f[k] for f in fs] for k in (
                   "step_seconds", "fwd_bwd_seconds", "grad_mean_seconds",
                   "place_seconds", "held_values", "collectives")}}
               for name, fs in full.items()},
           "train": {name: {"losses": ranks[0]["train"][name]["losses"],
                            "bit_equal_losses":
                                ranks[0]["train"][name]["bit_equal_losses"],
                            "run_seconds": [r["train"][name]["run_seconds"]
                                            for r in ranks],
                            "holds": [r["train"][name]["holds"]
                                      for r in ranks]}
                     for name in SSM_MESH_TRAIN},
           "spawn_to_join_seconds": wall, "card": card}
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 32: tensor parallelism for the ssm, hybrid and "
        f"encoder-decoder families on a (2, 2) mesh, {card}: "
        f"{json.dumps(out)}")
    return out


def ssm_mesh_only(device, card: str) -> int:
    """``--ssm-mesh``: phase 32 alone. Its last line says that it is this
    partial run, never the full run's ``{"ok": true, ...}``."""
    import torch
    launches = {}
    out = phase_ssm_mesh(device, launches, card)
    log(json.dumps({"launches": launches["ssm_mesh"]}))
    log(card)
    log(json.dumps({"ssm_mesh_only": True, "seconds": out["seconds"],
                    "device": {"platform": "gpu",
                               "kind": torch.cuda.get_device_name(0),
                               "count": torch.cuda.device_count()}}))
    return 0


# ---------------------------------------------------------------------------
# phase 33: the Server on a mesh
# ---------------------------------------------------------------------------

# (a) and (b) on a (1, 4) mesh of the 4 ranks, bf16: (config, depth cut,
# batch, prompt), 16 new tokens, depths cut to the script's time budget.
# command-r-plus-104b at 2 of its 64 layers (a rank places 24 of the 96
# query heads, 2 of the 8 kv heads, 8,448 of d_ff 33,792 and 64,000 of
# the 256,000 vocab rows: 2.36 G values); its 4,608-token prompt is past
# the 4,096-token window, so the int8 arm's ring cache and banded prefill
# run on the mesh. zamba2-1.2b at 7 of its 38 Mamba2 layers (two
# segments, the shared block applied twice, each use with its own KV
# cache; 16 of the 64 SSD heads, 8 of the shared block's 32 kv heads,
# 8,000 vocab rows a rank) on 1,024 tokens
SERVE_MESH = dict(ranks=4, model=4, new=16, seed=33, timeout=900,
                  archs=(("command-r-plus-104b", dict(n_layers=2), 2, 4608),
                         ("zamba2-1.2b", dict(n_layers=7), 2, 1024)))
# the mesh's last prefill logits against the one-rank bf16 route's, within
# this factor of one device's bf16 floor: the one-rank bf16 route's
# distance (relative L2) from the same weights in f32, the yardstick phase
# 31 holds its gradient to
SERVE_MESH_FLOOR_FACTOR = 1.5
# (c) every family reduced, f32, on a (2, 2) mesh on the card against the
# same mesh on the CPU: (case, config, overrides, prompt); qwen2-1.5b's 80
# tokens are past its 64-token window (its ring arms)
SERVE_MESH_REDUCED = (
    ("qwen2", "qwen2-1.5b", {}, 80),
    ("qwen2-kvq", "qwen2-1.5b", {"kv_quant": True}, 80),
    ("qwen3-moe", "qwen3-moe-235b-a22b", {}, 32),
    ("llama4", "llama4-maverick-400b-a17b", {}, 32),
    ("internvl2", "internvl2-76b", {}, 32),
    ("mamba2", "mamba2-370m", {}, 32),
    ("zamba2", "zamba2-1.2b", {}, 32),
    ("whisper", "whisper-medium", {}, 32))
SERVE_MESH_REDUCED_RING = ("qwen2", "qwen2-kvq")
SERVE_MESH_KERNELS = ("sw_attention", "ssd_intra", "block_dist",
                      "scatter_save", "masked_restore")


def _serve_mesh_cfg(name: str, cut: dict, opts: dict):
    """Phase 33's config of ``name`` at its depth ``cut``, bf16 unless
    ``opts["dtype"]`` (``opts["reduced"]``: the reduced config, for a
    rehearsal on the CPU)."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(name, reduced=opts.get("reduced", False))
    return dataclasses.replace(cfg, dtype=opts.get("dtype", "bfloat16"),
                               **cut)


def _greedy(logits):
    import torch
    return torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)


def _ring_generate(cfg, params, batch: dict, n_new: int, ctx=None):
    """The ring arm: the prefill into a cache of ``cfg.sliding_window``
    slots (the banded prefill, ``cache_spec(use_window=True)``), then
    ``n_new - 1`` greedy decode steps over the ring. The batch's tokens
    (B, n_new)."""
    import torch
    from repro_torch.models import get_model, transformer
    ops = get_model(cfg)
    with torch.no_grad():
        spec = transformer.cache_spec(cfg, batch["tokens"].shape[1],
                                      use_window=True)
        logits, cache = transformer.prefill(params, batch, cfg, spec, ctx)
        toks = [_greedy(logits)]
        for _ in range(n_new - 1):
            logits, cache = ops.decode_step(params, cache, toks[-1], cfg,
                                            ctx)
            toks.append(_greedy(logits))
    return torch.cat(toks, dim=1)


def _as_f32(node):
    """``node``'s leaves cast to f32 in place, one leaf at a time (each
    model-dtype leaf is let go as its copy replaces it)."""
    for k, v in node.items():
        if isinstance(v, dict):
            _as_f32(v)
        else:
            node[k] = v.float()
    return node


def _serve_mesh_yardstick(device, opts: dict, work: Path) -> dict:
    """Phase 33(a)-(b)'s yardsticks on one rank in this process, each
    config alone: its weights and prompts drawn from the seed and written
    under ``work / name`` for the ranks; the one-rank route's prefill
    logits and greedy tokens in bf16 (and the int8 ring arm's, for the
    dense config); then the same weights cast to f32, leaf by leaf, and
    their prefill logits: one device's bf16 floor is the bf16 logits'
    distance from these."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.models import get_model
    from repro_torch.training.serve import Server
    from repro_torch.utils.tree import tree_flatten
    cuda = device.type == "cuda"
    out = {}
    for k, (name, cut, B, S) in enumerate(SERVE_MESH["archs"]):
        cfg = _serve_mesh_cfg(name, cut, opts)
        S = opts.get("seq", {}).get(name, S)
        ops = get_model(cfg)
        gen = torch.Generator(device=device).manual_seed(
            SEED + SERVE_MESH["seed"] + k)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        params = ops.init_params(gen, cfg, device=device)
        toks = torch.randint(0, cfg.vocab, (B, S), generator=gen,
                             device=device, dtype=torch.int32)
        t0 = time.perf_counter()
        _save_bits(params, work / name / "params")
        _save_bits({"tokens": toks}, work / name / "inputs")
        r = {"params": sum(t.numel() for t in tree_flatten(params)[0]),
             "save_seconds": time.perf_counter() - t0}
        batch = {"tokens": toks}
        with torch.no_grad():
            (logits, _), r["prefill_seconds"] = _timed(
                lambda: ops.prefill(params, batch, cfg))
            r["tokens"] = {"bf16": Server(cfg, params, device=device)
                           .generate(batch, SERVE_MESH["new"]).tolist()}
            if cfg.family == "dense":
                cq = dataclasses.replace(cfg, kv_quant=True)
                r["tokens"]["int8_ring"] = _ring_generate(
                    cq, params, batch, SERVE_MESH["new"]).tolist()
            bf16 = logits.float().cpu()
            del logits
            r["bf16_peak_gb"] = (torch.cuda.max_memory_allocated() / 1e9
                                 if cuda else 0.0)
            cfg32 = dataclasses.replace(cfg, dtype="float32")
            p32 = _as_f32(params)
            del params
            f32 = ops.prefill(p32, batch, cfg32)[0].float().cpu()
            del p32
        r["bf16_floor"] = _rel_l2(bf16, f32)
        r["peak_gb"] = (torch.cuda.max_memory_allocated() / 1e9
                        if cuda else 0.0)
        np.save(work / name / "one_bf16.npy", bf16.numpy())
        np.save(work / name / "f32.npy", f32.numpy())
        del toks, batch, bf16, f32
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        out[name] = r
    return out


@contextlib.contextmanager
def captured_kernel_calls():
    """A switch of this script around the serve kernels' CUDA wrappers:
    every launch of ssd_intra and sw_attention runs as it is, and its
    inputs and outputs are kept (references, no copies), so that each call
    can be held against its plain version after the path's launch counts
    were read (:func:`hold_captured_calls`), without running the path
    again."""
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.sw_attention import ops as sw_ops
    ssd_cuda, sw_cuda = ssd_ops.ssd_intra_cuda, sw_ops.sw_attention_cuda
    calls = []

    def ssd(*args):
        got = ssd_cuda(*args)
        calls.append(("ssd_intra", args, {}, got))
        return got

    def sw(q, k, v, *, window):
        got = sw_cuda(q, k, v, window=window)
        calls.append(("sw_attention", (q, k, v), {"window": window}, got))
        return got
    ssd_ops.ssd_intra_cuda, sw_ops.sw_attention_cuda = ssd, sw
    try:
        yield calls
    finally:
        ssd_ops.ssd_intra_cuda, sw_ops.sw_attention_cuda = ssd_cuda, sw_cuda


def hold_captured_calls(calls: list) -> dict:
    """Each call :func:`captured_kernel_calls` kept against its plain
    version on the same inputs: the tolerance ratios (``_close_ratio``,
    <= 1 passes) of each kernel's calls, in order."""
    from repro_torch.kernels.ssd_scan.ref import ssd_intra_ref
    ratios = {"ssd_intra": [], "sw_attention": []}
    for name, args, kw, got in calls:
        if name == "ssd_intra":
            r = max(_close_ratio(g, w)
                    for g, w in zip(got, ssd_intra_ref(*args)))
        else:
            r = _worst_element(got, sw_attention_plain(*args, **kw))["ratio"]
        ratios[name].append(r)
    return ratios


def _count(into: dict) -> None:
    """Add the launch counts read now to ``into``."""
    from repro_torch.kernels import _build
    for k, v in _build.LAUNCHES.items():
        into[k] = into.get(k, 0) + v


def _serve_mesh_full(device, opts: dict, ctx, k: int) -> dict:
    """Phase 33(a) or (b) on one rank for ``SERVE_MESH["archs"][k]``: this
    rank's model slices placed from the yardstick's files; the bf16 arm
    (``Server.generate``: its prefill's logits and each kernel call kept,
    :func:`_recording_prefill`), the int8 ring arm (the dense config); the
    serve-with-recovery flow, the ranks one at a time (a rank's params,
    checkpoint and restored tree are three trees of its slices); the bf16
    arm again on the restored weights. The launch counts of each window
    (set to 0 just before, read just after) are summed; every hold runs
    outside them."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.distributed import collectives
    from repro_torch.kernels import _build
    from repro_torch.sharding.partition import batch_rows, model_slices
    from repro_torch.training.serve import Server
    from repro_torch.utils.tree import tree_flatten
    name, cut, B, S = SERVE_MESH["archs"][k]
    work = Path(opts["work"]) / name
    cfg = _serve_mesh_cfg(name, cut, opts)
    cuda = device.type == "cuda"
    new = SERVE_MESH["new"]
    pos = ctx.mesh.position()
    slices = model_slices(_bits_shapes(work / "params"), ctx)
    params, place_s = _timed(
        lambda: _load_bits(work / "params", device, slices))
    out = {"place_seconds": place_s,
           "held_values": sum(t.numel() for t in tree_flatten(params)[0])}
    batch = _load_bits(work / "inputs", device)
    lo, hi = batch_rows(B, ctx)
    shard = {key: v[lo:hi] for key, v in batch.items()}
    S = shard["tokens"].shape[1]
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    collectives.reset_stats()
    launches: dict = {}
    _build.reset_launches()
    srv = Server(cfg, params, device=device, ctx=ctx)
    # the generate's own prefill gives the logits and the kernel calls the
    # holds read (no second prefill)
    rec: dict = {}
    srv.ops = _recording_prefill(srv.ops, rec)
    with captured_kernel_calls() as calls:
        toks, gen_s = _timed(lambda: srv.generate(batch, new))
    tokens = {"bf16": toks.tolist()}
    logits, pre_s = rec.pop("logits"), rec.pop("seconds")
    if cfg.family == "dense":
        cq = dataclasses.replace(cfg, kv_quant=True)
        ring, out["int8_ring_seconds"] = _timed(
            lambda: _ring_generate(cq, params, shard, new, ctx))
        tokens["int8_ring"] = ring.tolist()
    _count(launches)
    out["collectives"] = collectives.seconds_and_bytes()
    out.update(prefill_seconds=pre_s,
               prefill_tokens_per_s=(hi - lo) * S / pre_s,
               generate_seconds=gen_s,
               decode_seconds_per_step=(gen_s - pre_s) / (new - 1),
               serve_peak_gb=(torch.cuda.max_memory_allocated() / 1e9
                              if cuda else 0.0))
    np.save(work / f"mesh_logits_{pos}.npy", logits.float().cpu().numpy())
    del logits, srv
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # the serve-with-recovery flow on this rank's slices, one rank at a
    # time (three trees of command-r's slices a rank)
    params = _mesh_recovery(device, ctx, params, launches, name, out,
                            one_at_a_time=True)
    out["recovery_peak_gb"] = (torch.cuda.max_memory_allocated() / 1e9
                               if cuda else 0.0)
    _build.reset_launches()
    tokens["bf16_after_recovery"] = Server(
        cfg, params, device=device, ctx=ctx).generate(batch, new).tolist()
    _count(launches)
    out["launches"] = launches
    out["tokens"] = tokens
    out["peak_gb"] = (torch.cuda.max_memory_allocated() / 1e9
                      if cuda else 0.0)
    # each kernel call of the kept prefill against its plain version
    ratios = hold_captured_calls(calls)
    del calls, params
    want = {"sw_attention": (cfg.n_layers if cfg.family == "dense" else
                             -(-cfg.n_layers // cfg.attn_every)),
            "ssd_intra": cfg.n_layers if cfg.family == "hybrid" else 0}
    for kernel, n in want.items():
        got = ratios[kernel]
        check(len(got) == (n if cuda else 0) and all(x <= 1.0 for x in got),
              f"{name} rank {pos}: {len(got)} {kernel} calls (not {n}), "
              f"the worst {max(got, default=0.0):.3g} of the tolerance")
    out["per_call_worst_ratio"] = {kk: max(v, default=None)
                                   for kk, v in ratios.items()}
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return out


def _mesh_recovery(device, ctx, params, launches: dict, name: str,
                   out: dict, one_at_a_time: bool = False):
    """The serve-with-recovery flow on this rank's model slices ``params``:
    scar(1.0, 1), a 30% loss, the partial restore, its launches added to
    ``launches``, the save, restore and block scores held against their
    plain versions (:func:`_hold_recovery`, :func:`_hold_block_dist`) and
    recorded in ``out``; ``one_at_a_time``: the ranks of the mesh in turn
    (each holds its params, checkpoint and restored tree at once). Returns
    the restored tree."""
    import torch
    import torch.distributed as dist
    from repro_torch.core.controller import FTController
    from repro_torch.core.policy import CheckpointPolicy
    from repro_torch.kernels import _build
    cuda = device.type == "cuda"
    pos = ctx.mesh.position()
    _build.reset_launches()
    ctl = FTController(params, CheckpointPolicy.scar(fraction=1.0,
                                                     interval=1),
                       device=device)
    ctl.checkpoint_now(1, params)
    for turn in range(ctx.mesh.size if one_at_a_time else 1):
        dist.barrier()
        if one_at_a_time and turn != pos:
            continue
        lost = ctl.sample_failure(0.3)
        recovered, info = ctl.on_failure(params, lost)
        _count(launches)
        check(int(lost.sum()) > 0, f"{name} rank {pos}: no block lost")
        held = _hold_recovery(ctl, params, lost, recovered, info, name)
        part = ctl.partition
        del ctl
        held.update(_hold_block_dist(params, part, name))
        out.update(lost_blocks=info["lost_blocks"],
                   applied_sq=info["applied_sq"], recovery_held=held)
        params = recovered
        del recovered
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    dist.barrier()
    return params


def _serve_mesh_reduced(device, ctx) -> dict:
    """Phase 33(c) on one rank: each of ``SERVE_MESH_REDUCED`` in f32 on
    the (2, 2) mesh on the card and on the CPU, this rank's slices of the
    same weights (drawn whole here on the CPU, the same bits on every
    rank) and its data shard: the prefill's logits, its cache (floats
    within rtol 1e-4, atol 1e-4; int8 values one count apart counted) and
    every decode step's logits (the card's steps on the CPU's cache and
    tokens: an int8 value one count off moves a step's logits by up to
    3.5e-4) within rtol 1e-4, atol 1e-4; the ring arms of qwen2-1.5b the
    same; ``Server.generate``'s tokens equal."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.interop import from_numpy_tree, to_numpy_tree
    from repro_torch.models import get_model, transformer
    from repro_torch.sharding.partition import batch_rows, model_slices
    from repro_torch.training.serve import Server
    from repro_torch.utils.tree import flatten_with_path, keystr, tree_map
    new, B = 4, 4
    out = {}
    for k, (case, name, over, S) in enumerate(SERVE_MESH_REDUCED):
        cfg = dataclasses.replace(get_config(name, reduced=True), **over)
        ops = get_model(cfg)
        arrays = to_numpy_tree(ops.init_params(
            torch.Generator().manual_seed(SEED + 330 + k), cfg,
            device="cpu"))
        sl = model_slices(arrays, ctx)
        on = {"cpu": from_numpy_tree(arrays, "cpu", sl),
              "card": from_numpy_tree(arrays, device, sl)}
        rng = np.random.default_rng(SEED + 330 + k)
        rows = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(
            np.int32)}
        if cfg.family == "vlm":
            rows["patches"] = rng.standard_normal(
                (B, cfg.n_patches, cfg.vit_dim)).astype(np.float32)
        if cfg.family == "audio":
            rows["frames"] = rng.standard_normal(
                (B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
        batch = {"cpu": from_numpy_tree(rows, "cpu"),
                 "card": from_numpy_tree(rows, device)}
        lo, hi = batch_rows(B, ctx)
        shard = {d: {key: v[lo:hi] for key, v in b.items()}
                 for d, b in batch.items()}
        arms = [("linear", None)]
        if case in SERVE_MESH_REDUCED_RING:
            arms.append(("ring", transformer.cache_spec(cfg, S,
                                                        use_window=True)))
        r = {"flips": 0}
        with torch.no_grad():
            for arm, spec in arms:
                def pre(d):
                    if spec is None:
                        return ops.prefill(on[d], shard[d], cfg, ctx)
                    return transformer.prefill(on[d], shard[d], cfg, spec,
                                               ctx)
                l_cpu, c_cpu = pre("cpu")
                l_card, c_card = pre("card")
                ratio = _close_1e4(l_card, l_cpu)
                for (path, a), (_, b) in zip(flatten_with_path(c_card)[0],
                                             flatten_with_path(c_cpu)[0]):
                    if a.dtype == torch.int8:
                        d8 = (a.cpu().int() - b.int()).abs()
                        check(int(d8.max()) <= 1, f"33(c) {case} {arm}: "
                              f"{keystr(path)} off by {int(d8.max())}")
                        r["flips"] += int(d8.sum())
                    elif a.is_floating_point():
                        ratio = max(ratio, _close_1e4(a, b))
                    else:
                        check(torch.equal(a.cpu(), b), f"33(c) {case} "
                              f"{arm}: {keystr(path)} differs")
                carried = tree_map(lambda x: x.to(device), c_cpu)
                for _ in range(new - 1):
                    tok = _greedy(l_cpu)
                    l_cpu, c_cpu = ops.decode_step(on["cpu"], c_cpu, tok,
                                                   cfg, ctx)
                    l_card, carried = ops.decode_step(
                        on["card"], carried, tok.to(device), cfg, ctx)
                    ratio = max(ratio, _close_1e4(l_card, l_cpu))
                r[f"{arm}_ratio"] = ratio
                check(ratio <= 1.0, f"33(c) {case} {arm}: the card is "
                      f"{ratio:.3g} of rtol 1e-4, atol 1e-4 off the CPU")
        t_cpu = Server(cfg, on["cpu"], device="cpu", ctx=ctx).generate(
            batch["cpu"], new)
        t_card = Server(cfg, on["card"], device=device, ctx=ctx).generate(
            batch["card"], new)
        r["tokens_equal"] = bool(torch.equal(t_card.cpu(), t_cpu))
        check(r["tokens_equal"] and t_cpu.shape == (B, new),
              f"33(c) {case}: the card's tokens {t_card.tolist()}, the "
              f"CPU's {t_cpu.tolist()}")
        out[case] = r
    return out


def _serve_mesh_rank_body(rank: int, opts: dict) -> dict:
    """One rank of phase 33 (see :func:`phase_serve_mesh`)."""
    import torch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding.partition import make_dist_ctx
    device = torch.device(opts["device"])
    # four ranks share the machine's cores: (c)'s CPU runs take two each
    torch.set_num_threads(2)
    # the (1, 4) mesh of (a) and (b), then (c)'s (2, 2): every rank makes
    # both, in this order (their line groups are collective)
    wide = make_dist_ctx(make_host_mesh(model=SERVE_MESH["model"]))
    square = make_dist_ctx(make_host_mesh(model=2))
    out = {"rank": rank, "full": {}}
    for k, (name, _, _, _) in enumerate(SERVE_MESH["archs"]):
        out["full"][name] = _serve_mesh_full(device, opts, wide, k)
    t0 = time.perf_counter()
    out["reduced"] = _serve_mesh_reduced(device, square)
    out["reduced"]["seconds"] = time.perf_counter() - t0
    out["host_peak_gb"] = _host_peak_gb()
    return out


def phase_serve_mesh(device, launches: dict, card: str, opts=None) -> dict:
    """Phase 33: the ``Server`` on a mesh of 4 gloo ranks sharing the one
    card, every family's prefill and decode split over the ``model`` axis.

    (a) command-r-plus-104b at full width (d 12,288, GQA 96/8 of 128, d_ff
    33,792, the untied 256,000-row head; bf16) with 2 of its 64 layers on
    a (1, 4) mesh: each rank places only its slices from files this
    process wrote. Batch 2, prompt 4,608, 16 greedy tokens: the bf16 arm
    through ``Server.generate`` (a linear cache, causal prefill) and an
    int8 arm (``kv_quant``) with the ring cache (4,096 slots) and the
    banded prefill. Yardstick: the same weights on one rank in this
    process, in bf16 and in f32. Held: every rank returns the same
    tokens; the mesh's last prefill logits within a relative L2 of the
    one-rank bf16 route's logits of ``SERVE_MESH_FLOOR_FACTOR`` times one
    device's bf16 floor (the one-rank bf16 logits' distance from the f32
    ones); the serve-with-recovery flow on every rank (an ``FTController``
    over its slices, ``checkpoint_now``, 30% of the blocks lost,
    ``on_failure``, the bf16 arm again): the same tokens bit for bit;
    after the launch counts were read, each rank's sw_attention calls
    against the plain version (rtol 1e-4), and its block_dist,
    scatter_save and masked_restore against theirs. The tokens' agreement
    with the one-rank route is printed, not held.

    (b) zamba2-1.2b at full width, 7 of its 38 layers, on the same mesh
    (batch 2, prompt 1,024, 16 tokens): held as (a), ssd_intra's calls
    too.

    (c) every family reduced, f32, on a (2, 2) mesh on the card against
    the same mesh on the CPU (:func:`_serve_mesh_reduced`).

    ``launches["serve_mesh"]``: one count a rank, (a)'s and (b)'s windows.
    Printed with the card: each rank's peak device memory, prefill seconds
    and tokens/s, decode seconds a step, each collective's calls, bytes,
    seconds and staged bytes."""
    import numpy as np
    import torch
    t_phase = time.perf_counter()
    work = ROOT / "build" / f"serve_mesh_{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    opts = {"device": device.type, "work": str(work), "phase": 33,
            **(opts or {})}
    try:
        yard = _serve_mesh_yardstick(device, opts, work)
        log(f"phase 33(a)-(b): the one-rank yardsticks, {card}: "
            f"{json.dumps(yard)}")
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        ranks, wall = _mesh_ranks(work, opts, "33")
        logits = {name: {"one_bf16": np.load(work / name / "one_bf16.npy"),
                         "f32": np.load(work / name / "f32.npy"),
                         "mesh": [np.load(work / name /
                                          f"mesh_logits_{r}.npy")
                                  for r in range(SERVE_MESH["ranks"])]}
                  for name, _, _, _ in SERVE_MESH["archs"]}
    finally:
        shutil.rmtree(work, ignore_errors=True)

    counts = [{} for _ in ranks]
    full = {}
    for name, _, B, _ in SERVE_MESH["archs"]:
        fs = [r["full"][name] for r in ranks]
        y = yard[name]
        lg = logits[name]
        mesh = torch.from_numpy(lg["mesh"][0])
        one = torch.from_numpy(lg["one_bf16"])
        f32 = torch.from_numpy(lg["f32"])
        rel = _rel_l2(mesh, one)
        check(all(np.array_equal(m, lg["mesh"][0]) for m in lg["mesh"]),
              f"phase 33 {name}: the ranks' prefill logits differ")
        check(rel <= SERVE_MESH_FLOOR_FACTOR * y["bf16_floor"],
              f"phase 33 {name}: the mesh's last prefill logits are "
              f"{rel:.3g} (relative L2) off the one-rank bf16 route's, one "
              f"device's bf16 floor {y['bf16_floor']:.3g}")
        for arm, toks in fs[0]["tokens"].items():
            check(all(f["tokens"][arm] == toks for f in fs)
                  and np.asarray(toks).shape == (B, SERVE_MESH["new"]),
                  f"phase 33 {name} {arm}: the ranks' tokens differ")
        check(fs[0]["tokens"]["bf16_after_recovery"]
              == fs[0]["tokens"]["bf16"], f"phase 33 {name}: tokens differ "
              f"after the lossless recovery")
        for r, f in zip(ranks, fs):
            check(f["applied_sq"] == 0.0 and f["lost_blocks"] > 0,
                  f"phase 33 {name} rank {r['rank']}: recovery {f}")
            for kk, v in f["launches"].items():
                counts[r["rank"]][kk] = counts[r["rank"]].get(kk, 0) + v
        agree = {arm: float(np.mean(np.asarray(toks) == np.asarray(
            y["tokens"][arm]))) for arm, toks in fs[0]["tokens"].items()
            if arm in y["tokens"]}
        full[name] = {
            "logits_rel_l2_vs_one_bf16": rel,
            "logits_rel_l2_vs_f32": _rel_l2(mesh, f32),
            "bf16_floor": y["bf16_floor"],
            "over_floor": rel / max(y["bf16_floor"], 1e-30),
            "token_agreement_with_one_rank": agree,
            "one_rank_prefill_seconds": y["prefill_seconds"],
            **{kk: [f[kk] for f in fs] for kk in (
                "prefill_seconds", "prefill_tokens_per_s",
                "generate_seconds", "decode_seconds_per_step",
                "serve_peak_gb", "recovery_peak_gb", "peak_gb",
                "place_seconds", "held_values", "lost_blocks",
                "per_call_worst_ratio", "collectives")}}
        if "int8_ring_seconds" in fs[0]:
            full[name]["int8_ring_seconds"] = [f["int8_ring_seconds"]
                                               for f in fs]
    for r, cnt in zip(ranks, counts):
        for kk in SERVE_MESH_KERNELS:
            check(cnt.get(kk, 0) > 0, f"{kk} was not launched on rank "
                  f"{r['rank']} of the phase 33 serve path")
    launches["serve_mesh"] = counts
    out = {"yardstick": yard, "full": full,
           "reduced": [r["reduced"] for r in ranks],
           "host_peak_gb": [r["host_peak_gb"] for r in ranks],
           "spawn_to_join_seconds": wall, "card": card}
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 33: the Server on a mesh, {card}: {json.dumps(out)}")
    return out


def serve_mesh_only(device, card: str) -> int:
    """``--serve-mesh``: phase 33 alone. Its last line says that it is
    this partial run, never the full run's ``{"ok": true, ...}``."""
    import torch
    launches = {}
    out = phase_serve_mesh(device, launches, card)
    log(json.dumps({"launches": launches["serve_mesh"]}))
    log(card)
    log(json.dumps({"serve_mesh_only": True, "seconds": out["seconds"],
                    "device": {"platform": "gpu",
                               "kind": torch.cuda.get_device_name(0),
                               "count": torch.cuda.device_count()}}))
    return 0


# ---------------------------------------------------------------------------
# phase 34: the launch analytics
# ---------------------------------------------------------------------------

LAUNCH = dict(
    # ``jobs`` processes run a partial run's analyses beside the kernels'
    # build; the full run's (:data:`LATE_JOBS`) run in ``late_jobs``
    seed=34, jobs=8, late_jobs=3,
    # (b) rank 0 of the dry (16, 16) mesh: pair A's and pair C's baselines
    # at these depths of command-r-plus-104b
    rank=dict(arch="command-r-plus-104b",
              steps=(("A", "prefill", "prefill_32k"),
                     ("C", "decode", "decode_32k")),
              depths=(1, 2), groups=(3, 4, 6), runs=3),
    # (a) the roofline of phase 29's shapes on one card: command-r at 4 of
    # its 64 layers, the (1, 32768) prefill and batch 8 over a 32,832-slot
    # cache
    one_chip=dict(arch="command-r-plus-104b", layers=4, seq=32768,
                  prefill_batch=1, decode_batch=8, cache_slots=32768 + 64),
    # (c) qwen2-1.5b at full width on a (1, 4) mesh: 3 query heads and 1 kv
    # head a rank
    serve=dict(arch="qwen2-1.5b", batch=2, seq=1024, new=8),
    train=dict(layers=4, batch=2, seq=2048))
# the meta run's peak of the bytes a step allocates against the card's
# max_memory_allocated over the step's baseline
LAUNCH_TEMP_RTOL = 0.10
LAUNCH_FLOOR_FACTOR = 1.5


# the full run's host-only work, run after phase 9 beside phases 10-29
# (no hold there reads a host time, and the build before them runs alone)
# and joined before the mesh phases: phase 23's CPU runs and every meta
# analysis
LATE_JOBS = ("examples", "layer", "slice", "uneven", "launch")


def _launch_jobs(which=("layer", "slice", "uneven", "launch")) -> list:
    """The host-only jobs of ``which``, each ``(key, function, args)``:
    phase 23's CPU runs (``"examples"``, :func:`_examples_cpu`), first;
    the meta analyses: phase 37's depth probes and full-depth build and
    phase 36's full-depth meta run (``"layer"``, ``"slice"``) and phase
    35(a)'s ranks' steps (``"uneven"``), the longest, first, and
    phase 34(a)'s (``"launch"``): the four pairs' distinct analyses on the
    dry (16, 16) mesh, and the one-card roofline of phase 29's prefill and
    decode."""
    from repro_torch.launch import perf
    jobs, seen = [], set()
    if "examples" in which:
        jobs.append((("examples_cpu",), _examples_cpu, ()))
    if "layer" in which:
        from repro_torch.launch.dryrun import probe_plan
        n = len(probe_plan(_layer_train_cfg()[0])[0])
        jobs += [(("layer_train", i), _layer_train_meta, (i,))
                 for i in reversed(range(n))]
        jobs.append((("layer_train",), _layer_train_meta, ()))
    if "slice" in which:
        jobs.append((("slice_train",), _slice_train_meta, ()))
    if "uneven" in which:
        o = UNEVEN["rank"]
        for kind, _ in o["steps"]:
            jobs += [(("uneven", pos, kind), _uneven_meta, (pos, kind))
                     for pos in o["positions"]]
    if "launch" not in which:
        return jobs
    for p in perf.PAIRS.values():
        for over in ({}, p["overrides"]):
            key = ("pair", p["arch"], p["shape"],
                   tuple(sorted(over.items())))
            if key not in seen:
                seen.add(key)
                jobs.append((key, perf._analyze,
                             (p["arch"], p["shape"], dict(over), None)))
    for kind in ("prefill", "decode"):
        jobs.append((("one_chip", kind), _one_chip_roofline, (kind,)))
    return jobs


def _one_chip_roofline(kind: str) -> dict:
    """The roofline of phase 29's ``kind`` on one card (a dry (1, 1)
    mesh, the H100's figures)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_dry_mesh
    from repro_torch.launch.roofline import H100, step_roofline
    o = LAUNCH["one_chip"]
    cfg = dataclasses.replace(get_config(o["arch"]), n_layers=o["layers"])
    mesh = make_dry_mesh((1, 1), ("data", "model"))
    spec = dataclasses.replace(H100, chips=1)
    if kind == "prefill":
        return step_roofline(cfg, "prefill", o["prefill_batch"], o["seq"],
                             mesh, spec)
    return step_roofline(cfg, "decode", o["decode_batch"], o["seq"], mesh,
                         spec, cache_len=o["cache_slots"])


def _start_launch_jobs(which=("layer", "slice", "uneven", "launch"),
                       jobs: Optional[int] = None):
    """The jobs of :func:`_launch_jobs` (``which``) started in ``jobs``
    processes (default ``LAUNCH["jobs"]``; one torch thread each; meta or
    CPU tensors only, no CUDA): the pool, each job's future and the
    start's clock."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    from repro_torch.launch.dryrun import _one_thread
    t0 = time.perf_counter()
    pool = ProcessPoolExecutor(jobs or LAUNCH["jobs"],
                               mp_context=multiprocessing.get_context(
                                   "spawn"))
    return pool, {key: pool.submit(_one_thread, fn, args)
                  for key, fn, args in _launch_jobs(which)}, t0


def _join_launch_jobs(started) -> dict:
    """The results of :func:`_start_launch_jobs`'s analyses (``done``, by
    key), its processes stopped; ``seconds`` from their start to the
    last result, ``wait_seconds`` of it spent here."""
    pool, futures, t0 = started
    t1 = time.perf_counter()
    try:
        done = {key: f.result() for key, f in futures.items()}
    finally:
        pool.shutdown(cancel_futures=True)
    now = time.perf_counter()
    return {"done": done, "seconds": now - t0, "wait_seconds": now - t1}


def _recording_prefill(ops, into: dict):
    """``ops`` whose ``prefill`` keeps its last logits and its seconds in
    ``into`` (so a ``Server.generate`` gives the prefill's logits without a
    second prefill)."""
    import dataclasses
    import torch
    inner = ops.prefill

    def prefill(*args, **kw):
        cuda = torch.cuda.is_available()
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(*args, **kw)
        if cuda:
            torch.cuda.synchronize()
        into["seconds"] = time.perf_counter() - t0
        into["logits"] = out[0]
        return out
    return dataclasses.replace(ops, prefill=prefill)


def _launch_rank_costs(device, launches: dict) -> dict:
    """Phase 34(b): rank 0 of the dry (16, 16) mesh runs pair A's and pair
    C's baselines on the card at each of ``LAUNCH["rank"]["depths"]``, on
    real tensors, every collective through the counting stand-in (values
    are not held: without the other ranks they mean nothing). A first run
    keeps its sw_attention calls for the plain holds; the second is timed
    and read ``LAUNCH["rank"]["runs"]`` times: the median seconds, its
    argument bytes and the peak of ``max_memory_allocated`` over its own
    baseline. The launches of the timed runs are summed into
    ``launches``. Before them, sw_attention at
    each query group ``LAUNCH["rank"]["groups"]`` that a shared kv head
    gets (3, 4, 6) against its plain version."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import shape_params
    from repro_torch.kernels import _build
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_dry_production_mesh
    from repro_torch.kernels.sw_attention.kernel import sw_attention_cuda
    o = LAUNCH["rank"]
    mesh = make_dry_production_mesh()
    out = {"g_cases": {}}
    # the query groups a rank's kv head gets at the production mesh
    # (qwen2-1.5b's 3 at 4, internvl2-76b's 4, command-r-plus-104b's 6 at
    # 16) against the plain version, outside every launch window
    gen = torch.Generator(device=device).manual_seed(SEED + LAUNCH["seed"])
    for G in LAUNCH["rank"]["groups"]:
        q, k, v = (torch.randn(shp, generator=gen, device=device).to(
            torch.bfloat16) for shp in ((2, G, 4096, 128), (2, 4096, 128),
                                        (2, 4096, 128)))
        ratio = _worst_element(sw_attention_cuda(q, k, v, window=4096),
                               sw_attention_plain(q, k, v,
                                                  window=4096))["ratio"]
        out["g_cases"][G] = ratio
        check(ratio <= 1.0, f"34(b): sw_attention at G {G} is {ratio:.3g} "
              "of the tolerance off its plain version")
    for pair, kind, shape in o["steps"]:
        sp = shape_params(shape)
        r = {}
        for depth in o["depths"]:
            cfg = dataclasses.replace(get_config(o["arch"]), n_layers=depth,
                                      microbatch=1)
            step = dryrun.build_rank_step(cfg, kind, sp["batch"], sp["seq"],
                                          mesh, device)
            args_bytes = dryrun.storage_bytes(step.args)
            with captured_kernel_calls() as calls:
                step.run()
            torch.cuda.synchronize()
            ratios = hold_captured_calls(calls)["sw_attention"]
            del calls
            gc.collect()
            # the cached blocks stay: a timed run that went to cudaMalloc
            # for them read 2.6x slower at depth 1 (measured on one H100)
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            secs = []
            _build.reset_launches()
            for _ in range(o["runs"]):
                t0 = time.perf_counter()
                res = step.run()
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
                del res
            _count(launches)
            secs = statistics.median(secs)
            peak = torch.cuda.max_memory_allocated() - base
            del step
            gc.collect()
            torch.cuda.empty_cache()
            want = depth if kind == "prefill" else 0
            check(len(ratios) == want and all(x <= 1.0 for x in ratios),
                  f"34(b) {pair} depth {depth}: {len(ratios)} sw_attention "
                  f"calls (not {want}), worst {max(ratios, default=0):.3g} "
                  "of the tolerance")
            r[depth] = {"seconds": secs, "argument_bytes": args_bytes,
                        "peak_over_baseline_bytes": peak,
                        "sw_attention_worst_ratio": max(ratios, default=None)}
        d1, d2 = o["depths"]
        n = get_config(o["arch"]).n_layers
        delta = r[d2]["seconds"] - r[d1]["seconds"]
        r["seconds_at_full_depth"] = r[d1]["seconds"] - delta + n * delta
        out[pair] = r
    return out


def _launch_yardstick(device, opts: dict, work: Path) -> dict:
    """Phase 34(c)'s yardsticks on one rank in this process: qwen2-1.5b at
    full width, its weights and prompts drawn from the seed and written
    under ``work / "serve"`` for the ranks; the one-rank bf16 and int8
    routes' tokens (``Server.generate``) and bf16 prefill logits, then the
    f32 prefill logits of the same weights (one device's bf16 floor); then
    the train step's weights at ``LAUNCH["train"]["layers"]`` layers and
    its yardstick (:func:`_tp_yardstick`) under ``work / "train"``."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.training.serve import Server
    sv, tr = LAUNCH["serve"], LAUNCH["train"]
    cuda = device.type == "cuda"
    cfg = dataclasses.replace(get_config(sv["arch"], reduced=opts.get(
        "reduced", False)), dtype="bfloat16")
    ops = get_model(cfg)
    gen = torch.Generator(device=device).manual_seed(SEED + LAUNCH["seed"])
    params = ops.init_params(gen, cfg, device=device)
    B, S = sv["batch"], opts.get("seq", sv["seq"])
    toks = torch.randint(0, cfg.vocab, (B, S), generator=gen, device=device,
                         dtype=torch.int32)
    _save_bits(params, work / "serve" / "params")
    _save_bits({"tokens": toks}, work / "serve" / "inputs")
    batch = {"tokens": toks}
    out = {"tokens": {}}
    with torch.no_grad():
        (logits, _), out["prefill_seconds"] = _timed(
            lambda: ops.prefill(params, batch, cfg))
        out["tokens"]["bf16"] = Server(cfg, params, device=device).generate(
            batch, sv["new"]).tolist()
        cq = dataclasses.replace(cfg, kv_quant=True)
        out["tokens"]["int8"] = Server(cq, params, device=device).generate(
            batch, sv["new"]).tolist()
        bf16 = logits.float().cpu()
        del logits
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        p32 = _as_f32(params)
        del params
        f32 = ops.prefill(p32, batch, cfg32)[0].float().cpu()
        del p32
    out["bf16_floor"] = _rel_l2(bf16, f32)
    np.save(work / "one_bf16.npy", bf16.numpy())
    np.save(work / "f32.npy", f32.numpy())
    del bf16, f32, batch, toks
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ct = dataclasses.replace(cfg, n_layers=tr["layers"])
    params = get_model(ct).init_params(gen, ct, device=device)
    rows = torch.randint(0, ct.vocab, (tr["batch"], opts.get(
        "train_seq", tr["seq"]) + 1), generator=gen, device=device,
        dtype=torch.int32)
    _save_bits(params, work / "train" / "params")
    _save_bits({"tokens": rows}, work / "train" / "inputs")
    held = {"params": params}
    del params
    out["train"] = _tp_yardstick(ct, held, _lm_rows(rows), work / "train")
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9 if cuda \
        else 0.0
    return out


def _launch_rank_body(rank: int, opts: dict) -> dict:
    """One rank of phase 34(c) on the (1, 4) mesh, or of phase 35(b) on the
    (1, 8) mesh (``opts["model"]``): its model slices of qwen2-1.5b placed
    from the yardstick's files (its query range and the kv head it reads:
    3 and 1 a rank at 4; 2, 1, 2, 1, ... over 1 at 8); the bf16 and the
    int8 arm through ``Server.generate`` (the prefill's logits kept by
    :func:`_recording_prefill`), each arm's sw_attention calls kept and held
    against the plain version after the window's launch counts were read;
    with ``opts["recovery"]`` the serve-with-recovery flow on its slices
    (:func:`_mesh_recovery`) between the arms, so that the int8 arm serves
    the restored weights; then the TP train step (:func:`_tp_step`)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.distributed import collectives
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding.partition import (make_dist_ctx, model_slices,
                                                query_head_range)
    from repro_torch.training.serve import Server
    from repro_torch.utils.tree import tree_flatten
    device = torch.device(opts["device"])
    cuda = device.type == "cuda"
    work = Path(opts["work"])
    sv, tr = LAUNCH["serve"], LAUNCH["train"]
    model = opts.get("model", 4)
    ctx = make_dist_ctx(make_host_mesh(model=model))
    pos = ctx.mesh.position()
    cfg = dataclasses.replace(get_config(sv["arch"], reduced=opts.get(
        "reduced", False)), dtype="bfloat16")
    slices = model_slices(_bits_shapes(work / "serve" / "params"), ctx)
    params, place_s = _timed(
        lambda: _load_bits(work / "serve" / "params", device, slices))
    batch = _load_bits(work / "serve" / "inputs", device)
    att = params["layers"]["attn"]
    out = {"rank": rank, "place_seconds": place_s,
           "heads": [int(att["wq"].shape[-2]), int(att["wk"].shape[-2])],
           "query_heads": list(query_head_range(cfg.n_heads, cfg.n_kv_heads,
                                                model, pos)),
           "tokens": {}, "per_call_worst_ratio": {}, "calls": {},
           "groups": {}}
    launches: dict = {}
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    collectives.reset_stats()
    for arm, c in (("bf16", cfg),
                   ("int8", dataclasses.replace(cfg, kv_quant=True))):
        if arm == "int8" and opts.get("recovery"):
            # the serve-with-recovery flow between the arms: the int8 arm
            # then serves the restored weights
            rec = {}
            params = _mesh_recovery(device, ctx, params, launches,
                                    sv["arch"], rec)
            out["recovery"] = rec
            out["recovery_peak_gb"] = (torch.cuda.max_memory_allocated()
                                       / 1e9 if cuda else 0.0)
        srv = Server(c, params, device=device, ctx=ctx)
        rec: dict = {}
        srv.ops = _recording_prefill(srv.ops, rec)
        _build.reset_launches()
        with captured_kernel_calls() as calls:
            toks, gen_s = _timed(lambda: srv.generate(batch, sv["new"]))
        _count(launches)
        out["tokens"][arm] = toks.tolist()
        out[f"{arm}_prefill_seconds"] = rec["seconds"]
        out[f"{arm}_generate_seconds"] = gen_s
        out[f"{arm}_decode_seconds_per_step"] = (
            (gen_s - rec["seconds"]) / (sv["new"] - 1))
        if arm == "bf16":
            np.save(work / f"mesh_logits_{pos}.npy",
                    rec["logits"].float().cpu().numpy())
        # the query group of each call: the rank's heads over its kv head
        out["groups"][arm] = sorted({int(a[0].shape[1]) for n, a, _, _
                                     in calls if n == "sw_attention"})
        ratios = hold_captured_calls(calls)["sw_attention"]
        del calls, rec, srv
        out["calls"][arm] = len(ratios)
        out["per_call_worst_ratio"][arm] = max(ratios, default=None)
        check(len(ratios) == (cfg.n_layers if cuda else 0)
              and all(x <= 1.0 for x in ratios),
              f"{opts['phase']} rank {pos} {arm}: {len(ratios)} sw_attention "
              f"calls, the worst {max(ratios, default=0.0):.3g} of the "
              "tolerance")
    out["serve_peak_gb"] = (torch.cuda.max_memory_allocated() / 1e9
                            if cuda else 0.0)
    out["collectives"] = collectives.seconds_and_bytes()
    out["launches"] = launches
    del params, batch
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    ct = dataclasses.replace(cfg, n_layers=tr["layers"])
    tw = work / "train"
    slices = model_slices(_bits_shapes(tw / "params"), ctx)
    params = _load_bits(tw / "params", device, slices)
    inputs = _load_bits(tw / "inputs", device)
    rows = {k: v.cpu().numpy()
            for k, v in _lm_rows(inputs["tokens"]).items()}
    del inputs
    out["train"] = _tp_step(device, ct, ctx, params, slices, rows, tw)
    out["train"]["held_values"] = sum(
        t.numel() for t in tree_flatten(params)[0])
    out["host_peak_gb"] = _host_peak_gb()
    return out


def _hold_lm_mesh(tag: str, ranks: list, yard: dict, lg: dict, cfg,
                  model: int) -> dict:
    """Phase 34(c)'s or 35(b)'s holds on the ranks' reports (``tag``) of
    ``cfg`` on a ``(1, model)`` mesh:
    each rank's query and kv heads its ranges (``partition.
    query_head_range``, ``kv_head_range``); the prefill logits the same on
    every rank and within ``LAUNCH_FLOOR_FACTOR`` times one device's bf16
    floor of the one-rank bf16 route's (``lg``: the files the ranks and the
    yardstick wrote); each arm's tokens (phase 35's int8 arm after the
    recovery) the one-rank route's; the train loss within rtol
    ``MOE_MESH_LOSS_RTOL`` of the yardstick's and each gradient slice as
    phase 31(a) holds it. Returns the summary printed with the phase."""
    import numpy as np
    import torch
    from repro_torch.sharding.partition import kv_head_range, query_head_range
    sv = LAUNCH["serve"]
    mesh0 = torch.from_numpy(lg["mesh"][0])
    rel = _rel_l2(mesh0, torch.from_numpy(lg["one_bf16"]))
    check(all(np.array_equal(m, lg["mesh"][0]) for m in lg["mesh"]),
          f"{tag}: the ranks' prefill logits differ")
    check(rel <= LAUNCH_FLOOR_FACTOR * yard["bf16_floor"],
          f"{tag}: the mesh's last prefill logits are {rel:.3g} (relative "
          f"L2) off the one-rank bf16 route's, one device's bf16 floor "
          f"{yard['bf16_floor']:.3g}")
    for r in ranks:
        lo, hi = query_head_range(cfg.n_heads, cfg.n_kv_heads, model,
                                  r["rank"])
        klo, khi = kv_head_range(cfg.n_heads, cfg.n_kv_heads, model,
                                 r["rank"])
        check(r["heads"] == [hi - lo, khi - klo]
              and r["query_heads"] == [lo, hi],
              f"{tag} rank {r['rank']}: heads {r['heads']} (query range "
              f"{r['query_heads']}), not [{lo}, {hi}) over {khi - klo} kv")
        for arm, got in r["tokens"].items():
            toks = yard["tokens"][arm]
            check(got == toks
                  and np.asarray(toks).shape == (sv["batch"], sv["new"]),
                  f"{tag} rank {r['rank']} {arm}: tokens {got}, the "
                  f"one-rank route's {toks}")
        f, y = r["train"], yard["train"]
        lrel = abs(f["loss"] - y["loss"]) / abs(y["loss"])
        check(lrel <= MOE_MESH_LOSS_RTOL, f"{tag} rank {r['rank']}: train "
              f"loss {f['loss']}, yardstick {y['loss']}")
        for leaf, err in f["grad_rel_l2_by_leaf"].items():
            floor = y["bf16_floor"][leaf]
            check(err <= max(MOE_MESH_GRAD_L2, MOE_MESH_FLOOR_FACTOR * floor),
                  f"{tag} rank {r['rank']}: gradient slice {leaf} off the "
                  f"f32 yardstick by relative L2 {err}, one device's bf16 "
                  f"gradient by {floor}")
    keys = ["bf16_prefill_seconds", "int8_prefill_seconds",
            "bf16_decode_seconds_per_step", "int8_decode_seconds_per_step",
            "serve_peak_gb", "place_seconds", "per_call_worst_ratio",
            "calls", "groups", "query_heads", "host_peak_gb"]
    keys += [k for k in ("recovery", "recovery_peak_gb") if k in ranks[0]]
    return {
        "logits_rel_l2_vs_one_bf16": rel,
        "bf16_floor": yard["bf16_floor"],
        "over_floor": rel / max(yard["bf16_floor"], 1e-30),
        "one_rank_prefill_seconds": yard["prefill_seconds"],
        "yardstick_peak_gb": yard["peak_gb"],
        **{k: [r[k] for r in ranks] for k in keys},
        "collectives": [r["collectives"] for r in ranks],
        "train": {"yardstick_loss": yard["train"]["loss"],
                  **{k: [r["train"][k] for r in ranks] for k in (
                      "loss", "step_seconds", "peak_gb", "grad_rel_l2",
                      "grad_worst_leaf", "held_values")}}}


def _mesh_logits(work: Path, n: int) -> dict:
    """The one-rank bf16 and f32 prefill logits the yardstick wrote, and
    the ``n`` ranks' (:func:`_hold_lm_mesh`)."""
    import numpy as np
    return {"one_bf16": np.load(work / "one_bf16.npy"),
            "f32": np.load(work / "f32.npy"),
            "mesh": [np.load(work / f"mesh_logits_{r}.npy")
                     for r in range(n)]}


def _gb(x) -> float:
    return float(x) / 1e9


def phase_launch(device, launches: dict, card: str, analyses: dict,
                 opts=None, measured: Optional[dict] = None,
                 keep: Optional[dict] = None) -> dict:
    """Phase 34: the launch analytics (``launch.dryrun``, ``roofline``,
    ``perf``) beside the card, and the shared kv heads on it.

    (a) ``analyses`` (:func:`_join_launch_jobs`): run in ``LAUNCH["jobs"]``
    processes on meta tensors (``main``; :data:`LATE_JOBS`), joined
    before phase 30: the four §Perf pairs (A, B, C, B2) at full width on
    one rank of
    the dry (16, 16) mesh (``launch.perf``: each pair's baseline and
    variant on the H100's roofline terms), and the roofline on one card of
    phase 29's shapes (command-r-plus-104b at 4 of 64 layers: the (1,
    32768) prefill, batch 8 over a 32,832-slot cache), printed beside
    phase 29's measured seconds when this run has them (``measured``), with
    the ratio of the measured time to the roofline's largest term.

    (b) :func:`_launch_rank_costs`: pair A's and pair C's baselines on
    rank 0 of the dry (16, 16) mesh (command-r-plus-104b: 6 query heads
    and the one kv head they read, 1/16 of the MLP and the vocab, the
    batch's data shard) on the card at depths 1 and 2. Held: each
    ``argument_bytes`` equal to the meta probe's at the same depth
    (pair A's and C's baseline analyses), the meta ``temp_bytes`` within
    ``LAUNCH_TEMP_RTOL`` of the card's peak over the step's baseline, the
    prefill's sw_attention calls against the plain version, and the kernel
    at the query groups 3, 4 and 6 a shared kv head gets. Printed: the
    measured seconds, extrapolated to 64 layers as the depth probes are,
    beside the rank's ``compute_s`` and ``memory_s``.

    (c) qwen2-1.5b at full width on a (1, 4) mesh of 4 gloo ranks on the
    one card (:func:`_launch_rank_body`): a bf16 and an int8 arm served,
    then one TP train step at ``LAUNCH["train"]["layers"]`` layers. Held:
    each arm's tokens the same on every rank and equal to the one-rank
    route's; the mesh's last prefill logits within
    ``LAUNCH_FLOOR_FACTOR`` times one device's bf16 floor of the one-rank
    bf16 route's; every sw_attention call against its plain version; the
    train loss within rtol ``MOE_MESH_LOSS_RTOL`` of one rank's over the
    data shards and each gradient slice as phase 31(a) holds it.

    ``launches["launch"]``: the launches of (b)'s timed runs and (c)'s
    serve windows (rank 0's). Given ``keep``, (c)'s yardstick (``yard``)
    and its files (``work``) are left there for phase 35(b), which removes
    them."""
    import torch
    t_phase = time.perf_counter()
    opts = {"device": device.type, "phase": 34, **(opts or {})}
    done = analyses["done"]
    work = ROOT / "build" / f"launch_{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    opts["work"] = str(work)
    counts: dict = {}
    try:
        t0 = time.perf_counter()
        rank_costs = _launch_rank_costs(device, counts)
        rank_seconds = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        yard = _launch_yardstick(device, opts, work)
        gc.collect()
        torch.cuda.empty_cache()
        ranks, wall = _mesh_ranks(work, opts, "34")
        serve_seconds = time.perf_counter() - t0
        lg = _mesh_logits(work, len(ranks))
        if keep is not None:
            keep.update(yard=yard, work=work)
    finally:
        if "work" not in (keep or {}):
            shutil.rmtree(work, ignore_errors=True)
    out = {"card": card, "rank_seconds": rank_seconds,
           "serve_seconds": serve_seconds, "spawn_to_join_seconds": wall,
           "analyses_seconds": analyses["seconds"],
           "analyses_wait_seconds": analyses["wait_seconds"]}

    # (a) the pairs and the one-card roofline
    from repro_torch.launch import perf
    pairs = {}
    for name, p in perf.PAIRS.items():
        base = done[("pair", p["arch"], p["shape"], ())]
        opt = done[("pair", p["arch"], p["shape"],
                    tuple(sorted(p["overrides"].items())))]
        pairs[name] = perf.pair_record(name, base, opt)
    out["pairs"] = pairs
    one = {}
    for kind in ("prefill", "decode"):
        r = done[("one_chip", kind)]
        top = max(r["compute_s"], r["memory_s"], r["collective_s"])
        one[kind] = {k: r[k] for k in ("compute_s", "memory_s",
                                       "collective_s", "dominant")}
        one[kind]["flops"] = r["counts"]["flops"]
        one[kind]["bytes"] = r["counts"]["bytes"]
        if measured and measured.get(kind):
            one[kind]["measured_seconds"] = measured[kind]
            one[kind]["measured_over_roofline"] = measured[kind] / top
    out["one_card_roofline"] = one

    # (b) the rank's card run against its meta probes
    o = LAUNCH["rank"]
    base_of = {"A": done[("pair", perf.PAIRS["A"]["arch"],
                          perf.PAIRS["A"]["shape"], ())],
               "C": done[("pair", perf.PAIRS["C"]["arch"],
                          perf.PAIRS["C"]["shape"], ())]}
    for pair, r in rank_costs.items():
        if pair == "g_cases":
            continue
        ana = base_of[pair]
        probes = {p["depth"]["n_layers"]: p for p in ana["probes"]}
        for depth in o["depths"]:
            got, meta = r[depth], probes[depth]
            got["meta_argument_bytes"] = int(meta["argument_bytes"])
            got["meta_temp_bytes"] = int(meta["temp_bytes"])
            got["temp_over_card_peak"] = (meta["temp_bytes"]
                                          / max(got["peak_over_baseline_"
                                                    "bytes"], 1))
            check(got["argument_bytes"] == int(meta["argument_bytes"]),
                  f"34(b) {pair} depth {depth}: the card's argument bytes "
                  f"{got['argument_bytes']}, the meta run's "
                  f"{meta['argument_bytes']}")
            check(abs(got["temp_over_card_peak"] - 1.0) <= LAUNCH_TEMP_RTOL,
                  f"34(b) {pair} depth {depth}: the meta temp_bytes "
                  f"{meta['temp_bytes']:.4g} against the card's peak over "
                  f"its baseline {got['peak_over_baseline_bytes']:.4g}")
        r["compute_s"], r["memory_s"] = ana["compute_s"], ana["memory_s"]
        r["collective_s"] = ana["collective_s"]
        r["measured_over_roofline"] = r["seconds_at_full_depth"] / max(
            ana["compute_s"], ana["memory_s"], ana["collective_s"])
    out["rank"] = rank_costs

    # (c) the shared kv heads on the card
    from repro_torch.configs import get_config
    cfg = get_config(LAUNCH["serve"]["arch"],
                     reduced=opts.get("reduced", False))
    out["serve"] = _hold_lm_mesh("34(c)", ranks, yard, lg, cfg, 4)
    for kk, v in ranks[0]["launches"].items():
        counts[kk] = counts.get(kk, 0) + v
    check(counts.get("sw_attention", 0) > 0,
          "sw_attention was not launched on the phase 34 path")
    launches["launch"] = counts
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 34: the launch analytics, {card}: {json.dumps(out)}")
    return out


def launch_only(device, card: str, analyses: dict) -> int:
    """``--launch``: phase 34 alone. Its last line says that it is this
    partial run, never the full run's ``{"ok": true, ...}``."""
    import torch
    launches = {}
    out = phase_launch(device, launches, card, analyses)
    log(json.dumps({"launches": launches["launch"]}))
    log(card)
    log(json.dumps({"launch_only": True, "seconds": out["seconds"],
                    "device": {"platform": "gpu",
                               "kind": torch.cuda.get_device_name(0),
                               "count": torch.cuda.device_count()}}))
    return 0


# ---------------------------------------------------------------------------
# phase 35: query heads that do not split over the model axis
# ---------------------------------------------------------------------------

UNEVEN = dict(
    seed=35,
    # (a) ranks 0 and 1 of the dry (16, 16) mesh: llama4-maverick's first
    # dense + MoE pair at full width, 3 and 2 of its 40 query heads over
    # the kv head they share, the dry run's prefill_32k and decode_32k
    rank=dict(arch="llama4-maverick-400b-a17b", layers=2, positions=(0, 1),
              steps=(("prefill", "prefill_32k"), ("decode", "decode_32k")),
              runs=2),
    # rank 3 of qwen2-1.5b's (16, 16) mesh holds no query head: its
    # prefill_32k at 2 layers launches no sw_attention
    empty=dict(arch="qwen2-1.5b", layers=2, position=3,
               shape="prefill_32k"),
    # sw_attention at the query groups these meshes give a rank
    # (llama4-maverick's 3 and 2 at 16, qwen2-1.5b's 2 and 1 at 8) on
    # (BH, G, S, Dh) = (2, G, 4096, 128), W 4096, timed beside its plain
    # version, its bound and SDPA
    groups=(3, 2, 1), group_shape=(2, 4096, 128, 4096),
    # (b) qwen2-1.5b at full width and depth served on a (1, 8) mesh of
    # gloo ranks (phase 34(c)'s yardstick, weights, prompts and train step):
    # 2, 1, 2, 1, ... query heads over the kv head of their half
    ranks=8)
# the kernels phase 35's path launches: sw_attention in the prefills, the
# recovery flow's block scores, save and restore
UNEVEN_KERNELS = ("sw_attention", "block_dist", "scatter_save",
                  "masked_restore")


def _uneven_cfg(o: dict):
    """``o["arch"]`` at full width with ``o["layers"]`` layers, one
    microbatch (phase 35(a)'s configs)."""
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(o["arch"]), n_layers=o["layers"],
                               microbatch=1)


def _uneven_meta(pos: int, kind: str) -> dict:
    """Phase 35(a)'s meta run of model position ``pos``'s ``kind`` step on
    the dry (16, 16) mesh: the memory half of ``launch.dryrun.measure``
    (the argument bytes, and the peak the step's byte counter reads,
    ``temp_bytes``), which the card's run is held to. The FLOP counter is
    left out: it took a quarter of the prefill's 70 s on meta."""
    from repro_torch.data.synthetic import shape_params
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_dry_production_mesh
    o = UNEVEN["rank"]
    sp = shape_params(dict(o["steps"])[kind])
    step = dryrun.build_rank_step(_uneven_cfg(o), kind, sp["batch"],
                                  sp["seq"],
                                  make_dry_production_mesh(position=pos),
                                  "meta")
    args = dryrun.storage_bytes(step.args)
    with dryrun.StepCosts(step.args) as cm:
        step.run()
    return {"argument_bytes": args, "temp_bytes": cm.peak}


def _uneven_rank_costs(device, launches: dict, done: dict) -> dict:
    """Phase 35(a): sw_attention at each query group of
    ``UNEVEN["groups"]`` against its plain version, timed
    (:func:`_sw_attention_case`); then model positions 0 and 1 of the dry
    (16, 16) mesh run llama4-maverick's first dense + MoE pair on the card
    through the counting stand-in (values are not held: without the other
    ranks they mean nothing), each of the dry run's prefill_32k and
    decode_32k steps once with its sw_attention calls kept for the plain
    holds, then ``runs`` times timed (their launches summed into
    ``launches``), the argument bytes and the peak of
    ``max_memory_allocated`` over the step's baseline held against the
    meta run's (``done``, :func:`_uneven_meta`); then rank 3 of
    qwen2-1.5b's (16, 16) mesh, which holds no query head, whose prefill
    launches no sw_attention."""
    import torch
    from repro_torch.data.synthetic import shape_params
    from repro_torch.kernels import _build
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_dry_production_mesh
    from repro_torch.sharding.partition import query_head_range
    o = UNEVEN["rank"]
    cfg = _uneven_cfg(o)
    out = {"g_cases": {}}
    gen = torch.Generator(device=device).manual_seed(SEED + UNEVEN["seed"])
    BH, S, Dh, W = UNEVEN["group_shape"]
    for G in UNEVEN["groups"]:
        r = _sw_attention_case(BH, G, S, Dh, W, gen, device)
        _log_case(f"phase 35(a): sw_attention at G {G}", r)
        out["g_cases"][G] = r
    for pos in o["positions"]:
        mesh = make_dry_production_mesh(position=pos)
        lo, hi = query_head_range(cfg.n_heads, cfg.n_kv_heads, 16, pos)
        r = {"query_heads": [lo, hi]}
        for kind, shape in o["steps"]:
            sp = shape_params(shape)
            step = dryrun.build_rank_step(cfg, kind, sp["batch"], sp["seq"],
                                          mesh, device)
            args_bytes = dryrun.storage_bytes(step.args)
            with captured_kernel_calls() as calls:
                step.run()
            torch.cuda.synchronize()
            groups = [int(a[0].shape[1]) for n, a, _, _ in calls
                      if n == "sw_attention"]
            ratios = hold_captured_calls(calls)["sw_attention"]
            del calls
            gc.collect()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            secs = []
            _build.reset_launches()
            for _ in range(o["runs"]):
                t0 = time.perf_counter()
                res = step.run()
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
                del res
            _count(launches)
            peak = torch.cuda.max_memory_allocated() - base
            del step
            gc.collect()
            torch.cuda.empty_cache()
            meta = done[("uneven", pos, kind)]
            want = cfg.n_layers if kind == "prefill" else 0
            check(len(ratios) == want and all(x <= 1.0 for x in ratios)
                  and set(groups) <= {hi - lo},
                  f"35(a) rank {pos} {kind}: {len(ratios)} sw_attention "
                  f"calls (not {want}) at G {groups} (not {hi - lo}), the "
                  f"worst {max(ratios, default=0):.3g} of the tolerance")
            check(args_bytes == int(meta["argument_bytes"]),
                  f"35(a) rank {pos} {kind}: the card's argument bytes "
                  f"{args_bytes}, the meta run's {meta['argument_bytes']}")
            ratio = meta["temp_bytes"] / max(peak, 1)
            check(abs(ratio - 1.0) <= LAUNCH_TEMP_RTOL,
                  f"35(a) rank {pos} {kind}: the meta temp_bytes "
                  f"{meta['temp_bytes']:.4g} against the card's peak over "
                  f"its baseline {peak:.4g}")
            r[kind] = {"seconds": statistics.median(secs),
                       "argument_bytes": args_bytes,
                       "meta_argument_bytes": int(meta["argument_bytes"]),
                       "peak_over_baseline_bytes": peak,
                       "meta_temp_bytes": int(meta["temp_bytes"]),
                       "temp_over_card_peak": ratio, "groups": groups,
                       "sw_attention_worst_ratio": max(ratios,
                                                       default=None)}
        out[pos] = r
    # a rank with no query heads: no kv head, no cache columns, no launch
    e = UNEVEN["empty"]
    ce = _uneven_cfg(e)
    sp = shape_params(e["shape"])
    step = dryrun.build_rank_step(ce, "prefill", sp["batch"], sp["seq"],
                                  make_dry_production_mesh(
                                      position=e["position"]), device)
    att = step.args["params"]["layers"]["attn"]
    _build.reset_launches()
    with captured_kernel_calls() as calls:
        logits, cache = step.run()
    torch.cuda.synchronize()
    n_calls = len(calls)
    kept = dict(_build.LAUNCHES)
    check(att["wq"].shape[-2] == 0 and cache["k"].shape[3] == 0
          and n_calls == 0 and kept.get("sw_attention", 0) == 0
          and bool(torch.isfinite(logits).all()),
          f"35(a) rank {e['position']} of {e['arch']}: {att['wq'].shape[-2]} "
          f"query heads, cache {tuple(cache['k'].shape)}, {n_calls} "
          f"sw_attention calls, launches {kept}")
    out["empty_rank"] = {"position": e["position"],
                         "wq": list(att["wq"].shape),
                         "cache_k": list(cache["k"].shape),
                         "sw_attention_calls": n_calls}
    del step, att, logits, cache, calls
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_uneven_heads(device, launches: dict, card: str, analyses: dict,
                       opts=None, kept: Optional[dict] = None) -> dict:
    """Phase 35: query heads that do not split over the model axis. Each
    model position computes whole query heads, ``[ceil(r Hq / tp),
    ceil((r+1) Hq / tp))`` (``partition.query_head_range``), and holds the
    kv heads its range reads, the positions whose ranges read one kv head
    each a copy.

    (a) :func:`_uneven_rank_costs`: sw_attention at G 3, 2 and 1 against
    its plain version, timed beside its bound and SDPA; model positions 0
    and 1 of the dry (16, 16) mesh for llama4-maverick-400b-a17b at full
    width, its first dense + MoE pair (3 and 2 query heads over the kv
    head they share), the prefill_32k and decode_32k steps on the card.
    Held: the argument bytes equal to the meta run's (computed on the
    host before the mesh phases, :func:`_uneven_meta`), the meta temp
    bytes within
    ``LAUNCH_TEMP_RTOL`` of the card's peak over the step's baseline, every
    sw_attention call at its rank's G against the plain version; and rank
    3 of qwen2-1.5b's (16, 16) mesh, which holds no query head, launching
    no sw_attention in its prefill.

    (b) qwen2-1.5b at full width and depth on a (1, 8) mesh of 8 gloo
    ranks on the one card (:func:`_launch_rank_body`; 2, 1, 2, 1, ...
    query heads, ranks 0-3 sharing kv head 0 and 4-7 kv head 1): a bf16
    and an int8 arm of 2 x 1,024 + 8 tokens, the serve-with-recovery flow
    on every rank between the arms (the int8 arm serves the restored
    weights), then one TP train step at 4 layers. Held as phase 34(c)
    (:func:`_hold_lm_mesh`, phase 34(c)'s yardstick: ``kept`` from
    :func:`phase_launch`, else made here), with the recovery's save,
    restore and block scores against their plain versions, each rank's
    query range and its sw_attention calls at its G (2 or 1).

    ``launches["uneven_heads"]``: (a)'s timed runs and (b)'s windows on
    every rank (the serve arms and the recovery)."""
    import torch
    from repro_torch.configs import get_config
    t_phase = time.perf_counter()
    opts = {"device": device.type, "phase": 35, "model": UNEVEN["ranks"],
            "recovery": True, **(opts or {})}
    counts: dict = {}
    try:
        t0 = time.perf_counter()
        rank = _uneven_rank_costs(device, counts, analyses["done"])
        rank_seconds = time.perf_counter() - t0
        t0 = time.perf_counter()
        if kept and "work" in kept:
            work, yard = kept["work"], kept["yard"]
        else:
            work = ROOT / "build" / f"uneven_{os.getpid()}"
            work.mkdir(parents=True, exist_ok=True)
            yard = _launch_yardstick(device, {**opts, "work": str(work)},
                                     work)
        gc.collect()
        torch.cuda.empty_cache()
        opts["work"] = str(work)
        ranks, wall = _mesh_ranks(work, opts, "35", world=UNEVEN["ranks"])
        serve_seconds = time.perf_counter() - t0
        lg = _mesh_logits(work, len(ranks))
    finally:
        if kept and "work" in kept:
            shutil.rmtree(kept["work"], ignore_errors=True)
        elif "work" in opts:
            shutil.rmtree(opts["work"], ignore_errors=True)
    cfg = get_config(LAUNCH["serve"]["arch"],
                     reduced=opts.get("reduced", False))
    out = {"card": card, "rank": rank, "rank_seconds": rank_seconds,
           "serve_seconds": serve_seconds, "spawn_to_join_seconds": wall,
           "serve": _hold_lm_mesh("35(b)", ranks, yard, lg, cfg,
                                  UNEVEN["ranks"])}
    cuda = device.type == "cuda"
    for r in ranks:
        # the rank's own query group: its heads over the one kv head
        want = [r["heads"][0]] if cuda else []
        check(all(g == want for g in r["groups"].values()),
              f"35(b) rank {r['rank']}: sw_attention at G {r['groups']}, "
              f"not {want}")
        for kk, v in r["launches"].items():
            counts[kk] = counts.get(kk, 0) + v
    groups = sorted({g for r in ranks for gs in r["groups"].values()
                     for g in gs} | {g for p in UNEVEN["rank"]["positions"]
                                     for g in rank[p]["prefill"]["groups"]})
    out["sw_attention_groups"] = groups
    check(groups == ([1, 2, 3] if cuda else []),
          f"phase 35's path ran sw_attention at G {groups}, not 1, 2 and 3")
    for name in UNEVEN_KERNELS:
        check(counts.get(name, 0) > 0 or not cuda,
              f"{name} was not launched on the phase 35 path")
    launches["uneven_heads"] = counts
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 35: query heads that do not split over the model axis, "
        f"{card}: {json.dumps(out)}")
    return out


def uneven_only(device, card: str, analyses: dict) -> int:
    """``--uneven-heads``: phase 35 alone. Its last line says that it is
    this partial run, never the full run's ``{"ok": true, ...}``."""
    import torch
    launches = {}
    out = phase_uneven_heads(device, launches, card, analyses)
    log(json.dumps({"launches": launches["uneven_heads"]}))
    log(card)
    log(json.dumps({"uneven_heads_only": True, "seconds": out["seconds"],
                    "device": {"platform": "gpu",
                               "kind": torch.cuda.get_device_name(0),
                               "count": torch.cuda.device_count()}}))
    return 0


# ---------------------------------------------------------------------------
# phase 36: the mesh train step on the rank's model slices
# ---------------------------------------------------------------------------

# rank 0 of the dry (16, 16) mesh: granite-8b at full width and depth (36
# layers), f32 as the dry run, train_4k (the rank's data shard: 16 of the
# 256 sequences of 4,096 tokens); one step, timed
SLICE_TRAIN = dict(arch="granite-8b", shape="train_4k")
SLICE_TRAIN_PEAK_BYTES = 80e9


def _plan_books(plan, microbatch: int) -> dict:
    """What a step's exchange books on the rank (the stand-in's
    all-gathers and reduce-scatters), from ``plan``'s groups: the outer
    group gathered once, each layer in every microbatch's forward and
    recompute; a reduce a group and microbatch, landing the group's words
    of the rank's span."""
    layers = range(1, plan.n_groups)
    return {"gather_count": 1 + 2 * microbatch * len(layers),
            "gather_bytes": 4 * (plan.group_values(0) + 2 * microbatch * sum(
                plan.group_values(g) for g in layers)),
            "reduce_count": microbatch * plan.n_groups,
            "reduce_bytes": 4 * microbatch * sum(
                plan.owned_words(plan.pos, g) for g in range(plan.n_groups)),
            "groups": plan.n_groups, "slice_values": _slice_values(plan),
            "largest_group_values": max(plan.group_values(g)
                                        for g in range(plan.n_groups))}


def _slice_values(plan) -> int:
    """The values of the rank's model slices: its groups' together."""
    return sum(plan.group_values(g) for g in range(plan.n_groups))


def _books_held(books: dict, want: dict) -> bool:
    return (books["all-gather"]["count"] == want["gather_count"]
            and books["all-gather"]["bytes"] == want["gather_bytes"]
            and books["reduce-scatter"]["count"] == want["reduce_count"]
            and books["reduce-scatter"]["bytes"] == want["reduce_bytes"])


def _rank_train_meta(arch: str, shape: str) -> dict:
    """Rank 0 of the dry (16, 16) mesh running ``arch``'s ``shape`` train
    step once on meta tensors at full depth (``dryrun.measure``): its
    argument and temp bytes and its collectives' books, and what the
    plan's groups add up to (:func:`_plan_books`)."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import shape_params
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_dry_production_mesh
    sp = shape_params(shape)
    cfg = get_config(arch)
    step = dryrun.build_rank_step(cfg, "train", sp["batch"], sp["seq"],
                                  make_dry_production_mesh(), "meta")
    plan = step.info["slice_plan"]
    full = dryrun.measure(step)
    full["plan"] = _plan_books(plan, max(cfg.microbatch, 1))
    full["slice_values"] = _slice_values(plan)
    full["arena_words"] = step.info["arena_words"]
    return full


def _slice_train_meta() -> dict:
    """Phase 36's step at full depth on meta (:func:`_rank_train_meta`),
    beside the depth probes' record (``dryrun.dry_record``)."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_dry_production_mesh
    o = SLICE_TRAIN
    return {"full": _rank_train_meta(o["arch"], o["shape"]),
            "record": dryrun.dry_record(o["arch"], o["shape"],
                                        make_dry_production_mesh())}


def phase_slice_train(device, card: str, analyses: dict) -> dict:
    """Phase 36: the mesh train step on the rank's model slices. Rank 0 of
    the dry (16, 16) mesh runs granite-8b's ``train_4k`` step at full
    width and depth on the card (``dryrun.build_rank_step``: the arena
    step over the rank's span, its slices gathered and their gradient sent
    through the counting stand-in, whose values are unset), once, timed
    with no untimed step before it (the script's budget; the first and a
    later step read 9.37 and 9.36 s in a full run): its seconds, the peak
    of ``max_memory_allocated`` over the step's baseline. Held
    against the same step's full-depth meta run (``analyses``, computed
    in a host process before the mesh phases, :func:`_slice_train_meta`):
    the argument
    bytes equal, the peak within ``LAUNCH_TEMP_RTOL`` of its temp bytes
    and under ``SLICE_TRAIN_PEAK_BYTES``, the gathers' and reduces'
    counts and result bytes (the stand-in's all-gathers and
    reduce-scatters) what the plan's groups add up to, on the card and on
    meta (:func:`_plan_books`), the rank's slices under a fifteenth of
    the arena; the depth probes' record beside it. No kernel of the port
    is on this path: the optimizer's apply and the training attention are
    plain torch."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import shape_params
    from repro_torch.distributed import collectives
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_dry_production_mesh
    o = SLICE_TRAIN
    t_phase = time.perf_counter()
    meta = analyses["done"][("slice_train",)]
    full, record = meta["full"], meta["record"]
    check(record["ok"] and not record.get("skipped"),
          f"36: the dry run's record failed: {record.get('error')}")
    cfg = get_config(o["arch"])
    sp = shape_params(o["shape"])
    t0 = time.perf_counter()
    step = dryrun.build_rank_step(cfg, "train", sp["batch"], sp["seq"],
                                  make_dry_production_mesh(), device)
    build_s = time.perf_counter() - t0
    plan = step.info["slice_plan"]
    values = _slice_values(plan)
    args_bytes = dryrun.storage_bytes(step.args)
    collectives.reset_stats()
    collectives.reset_dry_stats()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    res = step.run()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    del res
    peak = torch.cuda.max_memory_allocated() - base
    books = collectives.dry_stats()
    stats = collectives.seconds_and_bytes()
    words = step.info["arena_words"]
    del step, plan
    gc.collect()
    torch.cuda.empty_cache()
    temp = full["memory"]["temp_bytes"]
    out = {"card": card, "arch": o["arch"], "shape": o["shape"],
           "layers": cfg.n_layers, "build_seconds": build_s,
           "step_seconds": secs,
           "argument_bytes": args_bytes,
           "meta_argument_bytes": full["memory"]["argument_bytes"],
           "record_argument_bytes": record["memory"]["argument_bytes"],
           "peak_over_baseline_bytes": peak, "meta_temp_bytes": temp,
           "record_temp_bytes": record["memory"]["temp_bytes"],
           "temp_ratio": peak / temp, "slice_values": values,
           "arena_words": words, "gathered_bytes":
               books["all-gather"]["bytes"],
           "reduced_bytes": books["reduce-scatter"]["bytes"],
           "meta_flops": full["flops"], "stats": stats}
    check(args_bytes == full["memory"]["argument_bytes"],
          f"36: argument bytes {args_bytes} on the card, "
          f"{full['memory']['argument_bytes']} on meta")
    check(abs(peak / temp - 1.0) <= LAUNCH_TEMP_RTOL
          and peak < SLICE_TRAIN_PEAK_BYTES,
          f"36: the card's peak {peak} against the meta temp {temp}")
    want = full["plan"]
    out["plan"] = want
    check(_books_held(books, want)
          and _books_held(full["collectives"], want)
          and values == full["slice_values"] and 15 * values < words,
          f"36: gathered and reduced {books} and on meta "
          f"{full['collectives']}, the plan's groups {want}, {values} slice "
          f"values of {words} arena words")
    out["seconds_total"] = time.perf_counter() - t_phase
    log(f"phase 36: the mesh train step on the rank's model slices, "
        f"{card}: {json.dumps(out)}")
    return out


def slice_train_only(device, card: str, analyses: dict) -> int:
    """``--slice-train``: phase 36 alone. Its last line says that it is
    this partial run, never the full run's ``{"ok": true, ...}``."""
    import torch
    out = phase_slice_train(device, card, analyses)
    log(card)
    log(json.dumps({"slice_train_only": True,
                    "seconds": out["seconds_total"],
                    "device": {"platform": "gpu",
                               "kind": torch.cuda.get_device_name(0),
                               "count": torch.cuda.device_count()}}))
    return 0


# ---------------------------------------------------------------------------
# phase 37: the mesh train step gathers each layer's slices as it runs
# ---------------------------------------------------------------------------

# rank 0 of the dry (16, 16) mesh: llama4-maverick-400b-a17b at full width
# and depth (48 layers: 24 dense + MoE pairs, 128 experts, 8 a rank), f32
# as the dry run, train_4k at the config's microbatch 4 (the rank's data
# shard: 16 of the 256 sequences of 4,096 tokens, 4 a microbatch); one
# step, timed, with no untimed step before it (the script's budget); the
# plan's clipped lists are made before it, as a trainer's second step
# finds them. Its meta figures: the full-depth step built on meta (its
# argument bytes and the plan's books) and its two depth probes (one and
# two pairs), each a host job before the mesh phases (:data:`LATE_JOBS`):
# the full-depth meta run takes a pair's 21 s 24 times over (about 470 s
# on the card's host)
LAYER_TRAIN = dict(arch="llama4-maverick-400b-a17b", shape="train_4k")
LAYER_TRAIN_CARD_BYTES = 80e9


def _layer_train_cfg(**overrides):
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import shape_params
    return (dataclasses.replace(get_config(LAYER_TRAIN["arch"]), **overrides),
            shape_params(LAYER_TRAIN["shape"]))


def _layer_train_meta(probe: Optional[int] = None) -> dict:
    """Phase 37's figures on meta: with ``probe``, that depth probe of
    ``dryrun.probe_plan`` run once (``dryrun.measure``); without, the
    full-depth step built on meta, not run: its argument bytes and what
    the plan's groups add up to (:func:`_plan_books`)."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_dry_production_mesh
    cfg, sp = _layer_train_cfg()
    if probe is not None:
        cfg, _ = _layer_train_cfg(**dryrun.probe_plan(cfg)[0][probe])
    step = dryrun.build_rank_step(cfg, "train", sp["batch"], sp["seq"],
                                  make_dry_production_mesh(), "meta")
    if probe is not None:
        return dryrun._probe_record(dryrun.measure(step))
    return {"argument_bytes": dryrun.storage_bytes(step.args),
            "plan": _plan_books(step.info["slice_plan"],
                                max(cfg.microbatch, 1))}


def phase_layer_train(device, card: str, analyses: dict) -> dict:
    """Phase 37: the mesh train step that gathers each layer's model slices
    only while the layer runs and sends its gradient as the backward
    leaves it. Rank 0 of the dry (16, 16) mesh runs llama4-maverick's
    ``train_4k`` step at full width and depth on the card
    (``dryrun.build_rank_step``: the arena step over the rank's span, each
    group's slices gathered and its gradient sent through the counting
    stand-in, whose values are unset), once, timed. Held against the
    same step on meta (``analyses``, computed on the host before the mesh
    phases, :func:`_layer_train_meta`): the argument bytes equal to the
    full-depth step's built on meta, the peak of ``max_memory_allocated``
    over the step's baseline within ``LAUNCH_TEMP_RTOL`` of the temp bytes
    its depth probes extrapolate and under the card's
    ``LAYER_TRAIN_CARD_BYTES`` less the argument bytes, the gathers' and
    reduces' counts and bytes what the plan's groups add up to
    (:func:`_plan_books`), and no group's slices more than a tenth of all
    the rank's. No kernel of the port is
    on this path: the optimizer's apply and the training attention are
    plain torch."""
    import torch
    from repro_torch.distributed import collectives
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_dry_production_mesh
    o = LAYER_TRAIN
    t_phase = time.perf_counter()
    done = analyses["done"]
    built = done[("layer_train",)]
    want = built["plan"]
    cfg, sp = _layer_train_cfg()
    plan_of, extrapolate = dryrun.probe_plan(cfg)
    probes = [done[("layer_train", i)] for i in range(len(plan_of))]
    full = {k: extrapolate(*probes, k) for k in dryrun.PROBE_KEYS}
    mesh = make_dry_production_mesh()
    t0 = time.perf_counter()
    step = dryrun.build_rank_step(cfg, "train", sp["batch"], sp["seq"],
                                  mesh, device)
    plan = step.info["slice_plan"]
    comm = mesh.comm()
    for g in range(plan.n_groups):
        comm._slice_counts(plan, False, g)
        comm._slice_counts(plan, True, g)
        plan.owned_words(plan.pos, g)
    build_s = time.perf_counter() - t0
    args_bytes = dryrun.storage_bytes(step.args)
    collectives.reset_stats()
    collectives.reset_dry_stats()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    res = step.run()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    del res
    books = collectives.dry_stats()
    words = step.info["arena_words"]
    del step, plan
    gc.collect()
    torch.cuda.empty_cache()
    temp = full["temp_bytes"]
    out = {"card": card, "arch": o["arch"], "shape": o["shape"],
           "layers": cfg.n_layers, "microbatch": cfg.microbatch,
           "build_seconds": build_s, "step_seconds": secs,
           "argument_bytes": args_bytes,
           "meta_argument_bytes": built["argument_bytes"],
           "probes_argument_bytes": full["argument_bytes"],
           "peak_over_baseline_bytes": peak, "meta_temp_bytes": temp,
           "temp_ratio": peak / temp, "arena_words": words, "plan": want,
           "gathered_bytes": books["all-gather"]["bytes"],
           "reduced_bytes": books["reduce-scatter"]["bytes"],
           "collective_bytes": books["total_bytes"],
           "meta_collective_bytes": full["coll"],
           "meta_flops": full["flops"],
           "meta_tflops_per_s": full["flops"] / secs / 1e12,
           "probe_seconds": [p["run_s"] for p in probes],
           "stats": collectives.seconds_and_bytes()}
    check(args_bytes == built["argument_bytes"],
          f"37: argument bytes {args_bytes} on the card, "
          f"{built['argument_bytes']} on meta")
    check(abs(peak / temp - 1.0) <= LAUNCH_TEMP_RTOL
          and peak < LAYER_TRAIN_CARD_BYTES - args_bytes,
          f"37: the card's peak {peak} against the meta temp {temp}, "
          f"{args_bytes} argument bytes")
    check(_books_held(books, want)
          and 10 * want["largest_group_values"] < want["slice_values"],
          f"37: gathered and reduced {books}, the plan's groups {want}")
    out["seconds_total"] = time.perf_counter() - t_phase
    log(f"phase 37: the mesh train step gathering each layer's slices as "
        f"it runs, {card}: {json.dumps(out)}")
    return out


def layer_train_only(device, card: str, analyses: dict) -> int:
    """``--layer-train``: phase 37 alone. Its last line says that it is
    this partial run, never the full run's ``{"ok": true, ...}``."""
    import torch
    out = phase_layer_train(device, card, analyses)
    log(card)
    log(json.dumps({"layer_train_only": True,
                    "seconds": out["seconds_total"],
                    "device": {"platform": "gpu",
                               "kind": torch.cuda.get_device_name(0),
                               "count": torch.cuda.device_count()}}))
    return 0


def main(argv: list) -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    from repro_torch.utils.tree import tree_leaves

    device = torch.device("cuda", 0)
    card = card_line()
    log(f"card: {card}")
    last = [START]

    def lap(what: str) -> None:
        """Log the seconds since the last lap and since the script began."""
        now = time.perf_counter()
        log(f"time: {what} {now - last[0]:.1f} s (script {now - START:.1f} s)")
        last[0] = now

    int_rate = int32_ops_per_s()
    log(f"INT32 rate: {int_rate / 1e12:.3f} T operations/s "
        f"({torch.cuda.get_device_properties(0).multi_processor_count} SMs "
        f"x 64 lanes x the maximum SM clock)")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    # a partial run's meta analyses (meta tensors, the host alone) run
    # beside the kernels' build, where no window is timed, and are joined
    # before the first timed phase. The full run starts them and phase
    # 23's CPU runs (:data:`LATE_JOBS`) after phase 9 instead, in
    # ``LAUNCH["late_jobs"]`` processes beside phases 10-29, whose holds
    # read no host time, and joins them before the mesh phases
    partial = [a for a in argv if a.startswith("--")
               and a not in ("--launch", "--uneven-heads", "--slice-train",
                             "--layer-train")]
    which = tuple(k for k, flag in (("layer", "--layer-train"),
                                    ("slice", "--slice-train"),
                                    ("uneven", "--uneven-heads"),
                                    ("launch", "--launch"))
                  if flag in argv) or ("layer", "slice", "uneven", "launch")
    late = () if any(a.startswith("--") for a in argv) else LATE_JOBS
    started = None if partial or late else _start_launch_jobs(which)
    t0 = time.perf_counter()
    _build.library()
    built = _build.build_seconds
    log(f"kernels: {'built in ' + format(built, '.1f') + ' s' if built else 'reused'}"
        f" ({time.perf_counter() - t0:.1f} s to load)")
    analyses = None
    if started is not None:
        analyses = _join_launch_jobs(started)
        log(f"the meta runs of phases 34-37: the analyses took "
            f"{analyses['seconds']:.1f} s beside the build, "
            f"{analyses['wait_seconds']:.1f} s after it")

    if "--train" in argv:
        return train_only(device, card)
    if "--store" in argv:
        return store_only(device, card)
    if "--families" in argv:
        return families_only(device, card)
    if "--train-families" in argv:
        return train_families_only(device, card)
    if "--examples" in argv:
        return examples_only(device, card)
    if "--moe-vlm" in argv:
        return moe_vlm_only(device, card)
    if "--train-moe-vlm" in argv:
        return train_moe_vlm_only(device, card)
    if "--perf-variants" in argv:
        return perf_variants_only(device, card)
    if "--mesh" in argv:
        return mesh_only(device, card)
    if "--moe-mesh" in argv:
        return moe_mesh_only(device, card)
    if "--ssm-mesh" in argv:
        return ssm_mesh_only(device, card)
    if "--serve-mesh" in argv:
        return serve_mesh_only(device, card)
    if "--launch" in argv:
        return launch_only(device, card, analyses)
    if "--uneven-heads" in argv:
        return uneven_only(device, card, analyses)
    if "--slice-train" in argv:
        return slice_train_only(device, card, analyses)
    if "--layer-train" in argv:
        return layer_train_only(device, card, analyses)
    gen = torch.Generator(device=device).manual_seed(SEED)
    shapes = qwen2_1_5b_shapes()
    a_tree = _map_shapes(shapes, lambda s: torch.randn(
        s, generator=gen, device=device))
    if "--erasure" in argv:
        return erasure_only(a_tree, device, int_rate, card)
    b_tree = _map_shapes(shapes, lambda s: torch.empty(s, device=device))
    for x, y in zip(tree_leaves(a_tree), tree_leaves(b_tree)):
        y.copy_(x).add_(torch.randn(x.shape, generator=gen, device=device),
                        alpha=1e-2)
    lap("start-up and the kernels' build")
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
    lap("phases 2-9")
    late_started = _start_launch_jobs(late, LAUNCH["late_jobs"]) \
        if late else None

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
    lap("the MLR, quickstart and multi-erasure paths")
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
    log(f"peak device memory of the SCAR phases: "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    lap("the controller and fabric phases")

    # the LM serve path, after the 1.54 B tree and the controllers' cyclic
    # garbage are freed
    del a_tree
    gc.collect()
    torch.cuda.empty_cache()
    log(f"device memory in use before the serve phases: "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    kernels.update(phase_serve_kernels(device))
    lap("the serve kernels")
    mamba2 = phase_mamba2_serve(device, launches)
    torch.cuda.empty_cache()
    qwen2 = phase_qwen2_serve(device, launches)
    gc.collect()
    torch.cuda.empty_cache()
    lap("the mamba2 and qwen2 serve phases")
    train = train_phases(device, launches)
    gc.collect()
    torch.cuda.empty_cache()
    lap("phase 17")
    store = store_phases(device, launches)
    gc.collect()
    torch.cuda.empty_cache()
    lap("phase 18")
    families = family_phases(device, launches, card)
    lap("phases 19-20")
    train_families = train_family_phases(device, launches)
    lap("phases 21-22")
    examples = phase_examples(
        device, launches, None if late_started is None
        else late_started[1][("examples_cpu",)].result())
    gc.collect()
    torch.cuda.empty_cache()
    lap("phase 23")
    moe_vlm = moe_vlm_phases(device, launches, card)
    gc.collect()
    torch.cuda.empty_cache()
    lap("phases 24-26")
    train_moe_vlm = train_moe_vlm_phases(device, launches)
    gc.collect()
    torch.cuda.empty_cache()
    lap("phases 27-28")
    perf_variants = perf_variant_phases(device, launches, card)
    gc.collect()
    torch.cuda.empty_cache()
    lap("phase 29")
    if late_started is not None:
        analyses = _join_launch_jobs(late_started)
        log(f"phase 23's CPU runs and the meta runs of phases 34-37: "
            f"{analyses['seconds']:.1f} s from their start to the join, "
            f"{analyses['wait_seconds']:.1f} s waited there")
        lap("the later jobs' join")
    mesh = phase_mesh(device, launches, card)
    lap("phase 30")
    moe_mesh = phase_moe_mesh(device, launches, card)
    lap("phase 31")
    ssm_mesh = phase_ssm_mesh(device, launches, card)
    lap("phase 32")
    serve_mesh = phase_serve_mesh(device, launches, card)
    lap("phase 33")
    pv = perf_variants
    kept: dict = {}
    launch = phase_launch(device, launches, card, analyses, measured={
        "prefill": pv["perf_variants"]["prefill_off"]["seconds"],
        "decode": pv["perf_decode"]["bf16"]["seconds_per_step"]},
        keep=kept)
    lap("phase 34")
    uneven = phase_uneven_heads(device, launches, card, analyses,
                                kept=kept)
    lap("phase 35")
    slice_train = phase_slice_train(device, card, analyses)
    lap("phase 36")
    layer_train = phase_layer_train(device, card, analyses)
    lap("phase 37")
    log(json.dumps({"launches": launches}))
    old = ("block_dist", "scatter_save", "masked_restore")
    new = ("arena_maintain", "arena_scatter", "parity_xor")
    for path, names in (("mlr", old), ("controller", old),
                        ("mlr_fabric", new[:2]), ("fabric", new),
                        ("mlr_rs", ("gf256_mac",)),
                        ("rs_fabric", ("arena_maintain", "arena_scatter",
                                       "gf256_mac", "masked_restore")),
                        ("leaf_fabric", ("fused_maintain", "scatter_save",
                                         "parity_xor", "masked_restore")),
                        ("mamba2_serve", old + ("ssd_intra",)),
                        ("qwen2_serve", ("sw_attention",)),
                        ("zamba2_serve", old + ("ssd_intra", "sw_attention")),
                        ("whisper_serve", old + ("sw_attention",)),
                        ("qwen3_moe_serve", old + ("sw_attention",)),
                        ("llama4_serve", ("sw_attention",)),
                        ("internvl2_serve", old + ("sw_attention",)),
                        ("train", TRAIN_KERNELS),
                        ("zamba2_train", TRAIN_KERNELS),
                        ("whisper_train", TRAIN_KERNELS),
                        ("examples", EXAMPLE_KERNELS),
                        ("internvl2_train", TRAIN_KERNELS),
                        ("moe_train", TRAIN_KERNELS),
                        ("perf_variants", ("sw_attention",)),
                        ("launch", ("sw_attention",)),
                        ("uneven_heads", UNEVEN_KERNELS)):
        for name in names:
            check(launches[path][name] > 0,
                  f"{name} was not launched on the {path} path")

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
                      "rs_fabric"),
        "sw_attention": ("src/repro_torch/csrc/sw_attention.cu",
                         "src/repro/kernels/sw_attention/kernel.py:88",
                         "qwen2_serve"),
        "ssd_intra": ("src/repro_torch/csrc/ssd_intra.cu",
                      "src/repro/kernels/ssd_scan/kernel.py:52",
                      "mamba2_serve")}
    record = []
    for name, (source, replaces, path) in sources.items():
        r = kernels[name]
        record.append({"name": name, "route": "cuda", "source": source,
                       "replaces": replaces, "launches": launches[path][name],
                       "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                       "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                       "bound_by": r["bound_by"],
                       "library_ms": r["library_ms"],
                       "train_launches": launches["train"][name],
                       "store_launches": launches["store_async"][name]
                       + launches["store_disk"][name],
                       "zamba2_launches": launches["zamba2_serve"][name],
                       "whisper_launches": launches["whisper_serve"][name],
                       "zamba2_train_launches":
                           launches["zamba2_train"][name],
                       "whisper_train_launches":
                           launches["whisper_train"][name],
                       "examples_launches": launches["examples"][name],
                       "qwen3_moe_launches":
                           launches["qwen3_moe_serve"][name],
                       "llama4_launches": launches["llama4_serve"][name],
                       "internvl2_launches":
                           launches["internvl2_serve"][name],
                       "internvl2_train_launches":
                           launches["internvl2_train"][name],
                       "moe_train_launches": launches["moe_train"][name],
                       "perf_variants_launches":
                           launches["perf_variants"][name],
                       "mesh_launches": [r[name] for r in launches["mesh"]],
                       "moe_mesh_launches": [r.get(name, 0) for r in
                                             launches["moe_mesh"]],
                       "ssm_mesh_launches": [r.get(name, 0) for r in
                                             launches["ssm_mesh"]],
                       "serve_mesh_launches": [r.get(name, 0) for r in
                                               launches["serve_mesh"]],
                       "launch_launches": launches["launch"].get(name, 0),
                       "uneven_heads_launches":
                           launches["uneven_heads"].get(name, 0)})
    log(json.dumps({"controller": ctl, "fabric": fabric,
                    "rs_fabric": rs_fabric, "leaf_fabric": leaf_fabric,
                    "multi_erasure": multi, "mamba2_serve": mamba2,
                    "qwen2_serve": qwen2, "train": train, "store": store,
                    **families, **train_families, "examples": examples,
                    **moe_vlm, **train_moe_vlm, **perf_variants,
                    "mesh": {k: v for k, v in mesh.items() if k != "ranks"},
                    "moe_mesh": moe_mesh, "ssm_mesh": ssm_mesh,
                    "serve_mesh": serve_mesh, "launch": launch,
                    "uneven_heads": uneven, "slice_train": slice_train,
                    "layer_train": layer_train,
                    "serve_kernels": {
                        name: kernels[name]
                        for name in ("ssd_intra", "sw_attention")},
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
            "host_us_new_leaves", "alloc_us_one_buffer",
            "alloc_us_empty_like", "plain_host_us", "leaf_host_us",
            "per_leaf_ms", "per_leaf_plain_ms", "b2b_ms", "card_ms", "grid_launches", "work_items",
            "pairs")
            if k in r} for name, r in kernels.items() if "leaf_ms" in r},
        "masked_restore_arena": kernels["masked_restore_arena"],
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
    sys.exit(main(sys.argv[1:]))
