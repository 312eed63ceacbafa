"""The LM trainer on the card: the arena and PyTree paths bit-equal, and
the reduced trainers held against the same runs on the CPU.

Every test here is marked ``gpu`` and skips where there is no CUDA device.
The file imports neither JAX nor the JAX package:

    python -m pytest -q --noconftest -m gpu tests/test_torch_train_gpu.py

Tolerances: arena against PyTree bit-equal (deterministic algorithms on,
the same operands through the same kernels); card against CPU, losses
within rtol 1e-4 (f32, TF32 off; the two devices order their sums
differently), ``saved_iter`` and tier counts equal.
"""
import dataclasses
import os

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.arena import pack_arena
from repro_torch.core.policy import CheckpointPolicy
from repro_torch.data import ShardedLMDataset
from repro_torch.fabric import FabricConfig
from repro_torch.interop import to_numpy_tree
from repro_torch.kernels import _build
from repro_torch.models import get_model
from repro_torch.optim import adamw
from repro_torch.training import (ArenaTrainState, TrainLoop,
                                  TrainLoopConfig, TrainState)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _loop(cfg, device, arena_state=True, per_layer=True, schedule=None):
    return TrainLoop(cfg, adamw(3e-4), TrainLoopConfig(
        policy=CheckpointPolicy.scar(fraction=0.125, interval=2),
        fabric=FabricConfig(), arena_state=arena_state,
        per_layer_leaves=per_layer, fail_schedule=schedule), device=device)


def test_arena_and_pytree_bit_equal_on_the_card(cuda):
    """qwen2-1.5b at full width with 2 layers, bf16: 4 steps each way."""
    if os.environ.get("CUBLAS_WORKSPACE_CONFIG") is None:
        pytest.skip("set CUBLAS_WORKSPACE_CONFIG=:4096:8 before CUDA starts")
    cfg = dataclasses.replace(get_config("qwen2-1.5b"), n_layers=2)
    torch.use_deterministic_algorithms(True)
    try:
        runs = []
        for arena in (True, False):
            loop = _loop(cfg, cuda, arena_state=arena)
            state = loop.init_state(
                torch.Generator(device=cuda).manual_seed(3))
            assert isinstance(state, ArenaTrainState if arena
                              else TrainState)
            ds = ShardedLMDataset(cfg, 2, 1024, seed=0, device=cuda)
            state = loop.run(state, iter(ds), 4)
            ctl = loop.controller
            final = (state.arena if arena
                     else pack_arena(state.params, ctl.arena_layout))
            runs.append(([m["loss"] for m in loop.metrics],
                          ctl._ckpt_arena.clone(),
                          ctl.ckpt.saved_iter.clone(), final.clone()))
            del loop, state, ctl, final
            torch.cuda.empty_cache()
    finally:
        torch.use_deterministic_algorithms(False)
    (la, ca, sa, fa), (lt, ct, st, ft) = runs
    assert la == lt
    assert torch.equal(ca, ct) and torch.equal(sa, st)
    assert torch.equal(fa, ft)


@pytest.mark.parametrize("name", ["qwen2-1.5b", "mamba2-370m",
                                  "zamba2-1.2b", "whisper-medium",
                                  "qwen3-moe-235b-a22b",
                                  "llama4-maverick-400b-a17b",
                                  "internvl2-76b"])
def test_reduced_trainer_card_against_cpu(cuda, name):
    """The same weights, batches (whisper's frames included), policy and
    two-host loss (PARITY among its tiers) on both devices, in the
    reference's stacked partition; the card's run launches the five fabric
    kernels. The hybrid, encoder-decoder, MoE and VLM families train
    through the same trainer as the dense and ssm ones."""
    cfg = get_config(name, reduced=True)
    params = to_numpy_tree(get_model(cfg).init_params(
        torch.Generator().manual_seed(0), cfg, device="cpu"))
    sched = [(4, "host", 0), (4, "host", 2)]
    out = {}
    for dev in (cuda, torch.device("cpu")):
        loop = _loop(cfg, dev, per_layer=False, schedule=sched)
        state = loop.init_state(params=params)
        _build.reset_launches()
        loop.run(state, iter(ShardedLMDataset(cfg, 2, 64, seed=0,
                                              device=dev)), 6)
        info = loop.metrics[3]["failures"][0]
        out[dev.type] = ([m["loss"] for m in loop.metrics],
                         loop.controller.ckpt.saved_iter.cpu().tolist(),
                         info["tier_counts"], dict(_build.LAUNCHES))
    (lg, sg, tg, kg), (lc, sc, tc, _) = out["cuda"], out["cpu"]
    assert torch.allclose(torch.tensor(lg, dtype=torch.float64),
                          torch.tensor(lc, dtype=torch.float64),
                          rtol=1e-4, atol=0)
    assert sg == sc and tg == tc
    assert tg["PARITY"] > 0
    for kernel in ("arena_maintain", "arena_scatter", "masked_restore",
                   "block_dist", "parity_xor"):
        assert kg[kernel] > 0, kernel
