"""Async maintenance's stream protocol on the card.

Every test here is marked ``gpu`` and skips where there is no CUDA device.
The file imports neither JAX nor the JAX package:

    python -m pytest -q --noconftest -m gpu tests/test_torch_async_gpu.py

- The trainer with ``FabricConfig(async_maintain=True)`` against the same
  run synchronous: losses, the checkpoint arena, ``saved_iter`` and the
  final arena bit-equal (deterministic algorithms on); every sweep
  launched on the fabric's side stream.
- A failure while a sweep is in flight: the recovery settles it and
  restores every lost block bit-exactly from the published snapshot, even
  though the live arena was overwritten in place right after the maintain
  returned (as the next train step does).
- A save right after a maintain: it fences, reads the published slot, and
  leaves the checkpoint arena bit-equal to a synchronous controller's.
"""
import dataclasses
import os

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.controller import FTController
from repro_torch.core.policy import CheckpointPolicy
from repro_torch.data import ShardedLMDataset
from repro_torch.fabric import FabricConfig
from repro_torch.optim import adamw
from repro_torch.training import ArenaTrainState, TrainLoop, TrainLoopConfig
from repro_torch.utils.tree import tree_leaves

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def test_async_and_sync_trainers_bit_equal_on_the_card(cuda):
    """qwen2-1.5b at full width with 2 layers, bf16: 6 steps each way, a
    1/4 save every 2 steps."""
    if os.environ.get("CUBLAS_WORKSPACE_CONFIG") is None:
        pytest.skip("set CUBLAS_WORKSPACE_CONFIG=:4096:8 before CUDA starts")
    cfg = dataclasses.replace(get_config("qwen2-1.5b"), n_layers=2)
    torch.use_deterministic_algorithms(True)
    try:
        runs = {}
        for asy in (False, True):
            loop = TrainLoop(cfg, adamw(3e-4), TrainLoopConfig(
                policy=CheckpointPolicy.scar(fraction=0.25, interval=8),
                fabric=FabricConfig(async_maintain=asy)), device=cuda)
            state = loop.init_state(
                torch.Generator(device=cuda).manual_seed(5))
            assert isinstance(state, ArenaTrainState)
            state = loop.run(state, iter(ShardedLMDataset(
                cfg, 2, 512, seed=0, device=cuda)), 6)
            fab = loop.controller.fabric
            runs[asy] = ([m["loss"] for m in loop.metrics],
                         loop.controller._ckpt_arena.clone(),
                         loop.controller.ckpt.saved_iter.clone(),
                         state.arena.clone(), dict(fab.stats),
                         fab.side_stream_launches)
            del loop, state, fab
            torch.cuda.empty_cache()
    finally:
        torch.use_deterministic_algorithms(False)
    (ls, cs, ss, fs, _, _), (la, ca, sa, fa, stats, side) = \
        runs[False], runs[True]
    assert ls == la
    assert torch.equal(cs, ca) and torch.equal(ss, sa)
    assert torch.equal(fs, fa)
    assert stats["async_maintains"] == 6 == side
    assert stats["fence_count"] == 6


def _controller(device, asy: bool, seed: int = 0):
    gen = torch.Generator(device=device).manual_seed(seed)
    tree = {"a": torch.randn(4096, 1024, generator=gen, device=device),
            "b": torch.randn(2048, 768, generator=gen,
                             device=device).to(torch.bfloat16),
            "c": torch.randn(333, 64, generator=gen, device=device)}
    ctl = FTController(tree, CheckpointPolicy.scar(0.25, 8),
                       fabric=FabricConfig(async_maintain=asy),
                       device=device)
    assert ctl.arena_ready
    return tree, ctl


def _drift(live: torch.Tensor, step: int) -> None:
    """An in-place change of the live arena's words (as arena_apply makes
    one): flips the low bit of a strided set of words."""
    live[step::7] ^= 1


def test_failure_while_a_sweep_is_in_flight(cuda):
    tree, ctl = _controller(cuda, True)
    fab = ctl.fabric
    live = ctl.pack_live(tree)
    for step in (1, 2, 3):
        _drift(live, step)
        ctl.maintain(step, live)
    want = live.clone()
    n0 = fab.side_stream_launches
    _drift(live, 4)            # the next step writes in place at once
    assert fab.has_pending_maintenance and fab.published_epoch == 3
    lost = ctl.sample_failure(0.5)
    rec, info = ctl.on_failure(want.clone(), lost, step=3)
    assert not fab.has_pending_maintenance
    assert info["recovered_epoch"] == 3 and info["staleness"] == 0
    assert info["tier_counts"]["PEER_REPLICA"] == int(lost.sum())
    assert info["applied_sq"] == 0.0
    assert torch.equal(fab.replicas.arena, want)
    # the recovered arena is packed anew: compare the values (the drift
    # also flipped padding words, which a pack leaves zero)
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(ctl.unpack_live(rec)), tree_leaves(ctl.unpack_live(want))))
    assert fab.side_stream_launches == n0 == 3


def test_save_right_after_a_maintain(cuda):
    runs = {}
    for asy in (False, True):
        tree, ctl = _controller(cuda, asy)
        live = ctl.pack_live(tree)
        for step in range(1, 5):
            _drift(live, step)
            ctl.maintain(step, live)
            ctl.maybe_checkpoint(step, live)
            _drift(live, step + 10)   # the next step, before any fence
            _drift(live, step + 10)   # ... and back
        torch.cuda.synchronize()
        runs[asy] = (ctl._ckpt_arena.clone(), ctl.ckpt.saved_iter.clone(),
                     ctl.stats["saves"], ctl.fabric.stats["fence_count"])
    (cs, ss, ns, _), (ca, sa, na, fences) = runs[False], runs[True]
    assert ns == na == 2
    assert torch.equal(ss, sa)
    assert torch.equal(cs, ca)
    # maintains 2 and 4 settled epochs 1 and 3; the saves at 2 and 4
    # fenced the epochs they followed
    assert fences == 4
