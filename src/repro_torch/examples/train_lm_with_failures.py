"""End-to-end example: train an LM with SCAR fault tolerance, injecting
partial failures along the way.

The port of ``examples/train_lm_with_failures.py``: a small transformer,
the data pipeline, AdamW, the fault-tolerance controller with the fabric
and a persistent on-disk store, and failures drawn per step with
``--fail-prob`` as in the paper's §5.3. The trainer runs arena-resident by
default (the live state is the flat parameter arena, updated in place;
the maintenance sweep reads it without a pack and the partial save copies
straight from it); ``--pytree`` takes the PyTree path, whose losses are
bit-equal. ``--async-maintain`` runs the sweep of each step on a side
stream under the next step (``FabricConfig(async_maintain=True)``).

Run:  PYTHONPATH=src python -m repro_torch.examples.train_lm_with_failures \\
          [--steps 300] [--fail-prob 0.02] [--arch qwen2-1.5b] [--tiny] \\
          [--pytree] [--async-maintain] [--device cuda|cpu]

``--arch`` takes any config: dense (the default ``qwen2-1.5b``), moe
(``qwen3-moe-235b-a22b``; ``llama4-maverick-400b-a17b``, dense and MoE
layers interleaved), vlm (``internvl2-76b``, its batches carrying patch
embeddings), ssm (``mamba2-370m``), hybrid (``zamba2-1.2b``) and audio
(``whisper-medium``, its batches carrying frame embeddings). ``--tiny``
trains the reduced config for at most 20 steps; without it the reduced
config is scaled to about 100 M parameters. The store goes to a
temporary directory, removed at the end.
"""
from __future__ import annotations

import argparse
import dataclasses
import tempfile
from typing import Optional

import numpy as np

from repro_torch.checkpoint_io import ShardedCheckpointStore
from repro_torch.configs import get_config
from repro_torch.core.policy import CheckpointPolicy
from repro_torch.data import ShardedLMDataset
from repro_torch.device import resolve_device
from repro_torch.fabric import FabricConfig
from repro_torch.optim import adamw
from repro_torch.training import TrainLoop, TrainLoopConfig


def parse_args(argv: Optional[list] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--fail-prob", type=float, default=0.02)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--pytree", action="store_true",
                    help="the PyTree training state in place of the arena")
    ap.add_argument("--async-maintain", action="store_true",
                    help="run each step's maintenance sweep under the next")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    return ap.parse_args(argv)


def model_config(arch: str, tiny: bool):
    """(config, batch, seq): the reduced config, or it scaled to about
    100 M parameters by the reference's fields alone (the encoder's depth
    and the hybrid's ``attn_every`` stay the reduced ones, as there)."""
    base = get_config(arch, reduced=True)
    if tiny:
        return base, 2, 64
    cfg = dataclasses.replace(
        base, n_layers=8, d_model=768, n_heads=12, n_kv_heads=4,
        d_ff=2048, vocab=32000, d_head=64)
    return cfg, 8, 256


def train(args: argparse.Namespace, store_dir: str, params=None,
          verbose: bool = True) -> dict:
    """One run into the store under ``store_dir``. ``params`` (a numpy
    tree, e.g. the reference's initial parameters) replaces the seeded
    initialization. Returns the losses and the run's summaries."""
    device = resolve_device(args.device)
    cfg, batch, seq = model_config(args.arch, args.tiny)
    steps = min(args.steps, 20) if args.tiny else args.steps
    store = ShardedCheckpointStore(store_dir, device=device)
    loop = TrainLoop(cfg, adamw(3e-4), TrainLoopConfig(
        policy=CheckpointPolicy.scar(fraction=0.125, interval=8),
        fail_prob=args.fail_prob, fail_fraction=0.5,
        fabric=FabricConfig(async_maintain=args.async_maintain),
        arena_state=not args.pytree), store=store, device=device)
    state = loop.init_state(params=params)
    n = loop.controller.partition.total_params
    log = print if verbose else (lambda *a, **k: None)
    log(f"== training {args.arch}-derived LM: {n / 1e6:.1f}M params, "
        f"{steps} steps "
        f"on {device}, SCAR(r=1/8, partial recovery), p_fail="
        f"{args.fail_prob}/step, state="
        f"{'arena-resident' if loop.arena_layout is not None else 'pytree'}"
        f"{', async maintenance' if args.async_maintain else ''}")
    ds = ShardedLMDataset(cfg, batch, seq, device=device)

    def on_step(i, loss):
        if i % 20 == 0 or i == 1:
            log(f"   step {i:4d}  loss {loss:.4f}")

    state = loop.run(state, iter(ds), steps, on_step=on_step)
    failures = [m for m in loop.metrics if "failure" in m]
    ckpts = sum(1 for m in loop.metrics if m.get("checkpointed"))
    log(f"== done. {ckpts} partial checkpoints, {len(failures)} failures")
    for m in failures:
        f = m["failure"]
        log(f"   failure @step {m['step']}: lost {f['lost_blocks']:.0f} "
            f"blocks, ||d'||^2={f['partial_sq']:.4f} (full recovery would "
            f"be {f['full_sq']:.4f})")
    losses = [m["loss"] for m in loop.metrics]
    log(f"   loss {losses[0]:.3f} -> {np.mean(losses[-10:]):.3f} "
        f"(finite: {bool(np.isfinite(losses).all())})")
    stats = loop.controller.stats
    disk = store.disk_nbytes()
    log(f"   controller: {stats['saves']} saves, "
        f"{stats['bytes_mirrored'] / 1e6:.1f}MB mirrored, "
        f"{stats['save_seconds']:.2f}s total save time; store "
        f"{(disk['shard'] + disk['parity']) / 1e6:.1f}MB on disk")
    over = loop.overhead_summary()
    log(f"   per-step maintenance overhead: "
        f"{over['overhead_seconds_mean'] * 1e3:.1f} ms "
        f"({over.get('maintain_bytes_per_step', 0) / 1e6:.1f} MB/step "
        f"accounted) next to {over['step_seconds_mean'] * 1e3:.1f} ms/step "
        f"compute; arena-resident={over['arena_state']}, "
        f"{over.get('arena_resident_maintains', 0)} pack-free sweeps, "
        f"{over.get('async_maintains', 0)} async (overlap "
        f"{over['overlap_efficiency']:.2f})")
    return {"losses": losses, "failures": len(failures), "saves":
            stats["saves"], "arena_state": over["arena_state"],
            "overhead": over, "state": state, "loop": loop}


def main(argv: Optional[list] = None) -> dict:
    args = parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="scar_ckpt_") as d:
        return train(args, d)


if __name__ == "__main__":
    main()
