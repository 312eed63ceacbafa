"""Serving with SCAR-style weight recovery.

The port of ``examples/serve_with_recovery.py``. Serves a reduced model
(batched greedy decode with a cache), then simulates a partial weight loss
on the serving replica (a host dropping out of the inference pod) and
restores the lost blocks from the running checkpoint: generation goes on
without reloading the whole model, and its tokens are unchanged.

``--arch`` takes every configuration: dense (the default ``yi-9b``),
MoE (``qwen3-moe-235b-a22b``; ``llama4-maverick-400b-a17b``, dense and
MoE layers interleaved), VLM (``internvl2-76b``, whose batches carry patch
embeddings), ssm (``mamba2-370m``), hybrid (``zamba2-1.2b``) and audio
(``whisper-medium``, whose batches carry frame embeddings).

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_with_recovery \\
          [--arch yi-9b] [--batch 4] [--prompt-len 32] [--new-tokens 8] \\
          [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
from typing import Any, Optional

import torch

from repro_torch.configs import get_config
from repro_torch.core.blocks import ReplayDraws
from repro_torch.core.controller import FTController
from repro_torch.core.policy import CheckpointPolicy
from repro_torch.data.synthetic import lm_batch
from repro_torch.device import resolve_device
from repro_torch.examples.common import parser, printer
from repro_torch.interop import from_numpy_tree
from repro_torch.models import get_model
from repro_torch.training.serve import Server


def parse_args(argv: Optional[list] = None) -> argparse.Namespace:
    ap = parser(__doc__)
    ap.add_argument("--arch", default="yi-9b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=8)
    return ap.parse_args(argv)


def run(args: argparse.Namespace, params: Any = None, batch: Any = None,
        draws: Optional[list] = None, verbose: bool = True) -> dict:
    """Serve, lose 30% of the blocks, restore, serve again. ``params`` and
    ``batch`` (numpy trees, e.g. the reference's draws) replace the seeded
    weights and prompts, ``draws`` (``[lost block ids]``) the controller's
    draw of the failure (``core.blocks.ReplayDraws``). Returns the tokens
    before and after, the recovery's info and whether the generations are
    identical."""
    dev = resolve_device(args.device)
    log = printer(verbose)
    cfg = get_config(args.arch, reduced=True)
    ops = get_model(cfg)
    if params is None:
        params = ops.init_params(torch.Generator(device=dev).manual_seed(0),
                                 cfg, device=dev)
    else:
        params = from_numpy_tree(params, dev)
    if batch is None:
        batch = lm_batch(torch.Generator(device=dev).manual_seed(1), cfg,
                         args.batch, args.prompt_len, device=dev)
    else:
        batch = from_numpy_tree(batch, dev)
    srv = Server(cfg, params, device=dev)
    log(f"== serving {args.arch} (reduced): batch={args.batch}, "
        f"prompt={args.prompt_len}, +{args.new_tokens} tokens")
    toks0 = srv.generate(batch, args.new_tokens)
    log("   tokens (before failure):", toks0[0].cpu().numpy())

    # checkpoint the serving weights, lose 30% of the blocks, restore
    ctl = FTController(params, CheckpointPolicy.scar(fraction=1.0,
                                                     interval=1),
                       rng=None if draws is None else ReplayDraws(draws),
                       device=dev)
    ctl.checkpoint_now(1, params)
    recovered, info = ctl.on_failure(params, ctl.sample_failure(0.3))
    log(f"   failure: lost {info['lost_blocks']:.0f} blocks; restored from "
        f"running checkpoint (||d||^2={info['applied_sq']:.2e})")

    toks1 = Server(cfg, recovered, device=dev).generate(batch,
                                                        args.new_tokens)
    log("   tokens (after recovery): ", toks1[0].cpu().numpy())
    same = bool(torch.equal(toks0, toks1))
    log(f"== generations identical after lossless recovery: {same}")
    if not same:
        raise AssertionError("the checkpoint was fresh: recovery must be "
                             "exact")
    return {"tokens_before": toks0, "tokens_after": toks1, "info": info,
            "identical": same}


def main(argv: Optional[list] = None) -> dict:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
