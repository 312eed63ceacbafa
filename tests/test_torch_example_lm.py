"""The ported ``examples/train_lm_with_failures.py``
(``python -m repro_torch.examples.train_lm_with_failures``), on the CPU at
its ``--tiny`` size.

- Its exit, ROADMAP item 11's: the arena-resident and PyTree runs give
  bit-equal losses (with failures injected by ``--fail-prob``), and the
  async run's losses equal the synchronous run's;
- on the reference's initial parameters (carried as numpy) and the same
  token stream, its losses agree with the reference example's within rtol
  1e-4, the two make as many saves, and their stores stamp the same
  saved iterations;
- ``--arch zamba2-1.2b`` (the hybrid family), ``--arch whisper-medium``
  (the encoder-decoder, its batches carrying frames), ``--arch
  qwen3-moe-235b-a22b`` (MoE) and ``--arch internvl2-76b`` (VLM, its
  batches carrying patches) train at ``--tiny``, arena-resident and on the
  PyTree path bit-equal, failures included; the MoE and VLM runs agree
  with the reference example's as the dense one does.
"""
import jax
import numpy as np
import pytest
import torch

from repro.checkpoint_io import ShardedCheckpointStore as JStore
from repro.configs import get_config as j_get_config
from repro.core.policy import CheckpointPolicy as JPolicy
from repro.data.pipeline import ShardedLMDataset as JDataset
from repro.fabric import FabricConfig as JFabric
from repro.optim.optimizers import adamw as j_adamw
from repro.sharding import single_device_ctx
from repro.training import TrainLoop as JLoop
from repro.training import TrainLoopConfig as JLoopConfig
from repro_torch.examples import train_lm_with_failures as example


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(tmp_path, name, *flags, params=None):
    args = example.parse_args(["--tiny", "--device", "cpu", *flags])
    return example.train(args, str(tmp_path / name), params=params,
                         verbose=False)


def test_example_arena_pytree_and_async_bit_equal(tmp_path):
    flags = ("--steps", "6", "--fail-prob", "0.4")
    arena = _run(tmp_path, "arena", *flags)
    tree = _run(tmp_path, "tree", "--pytree", *flags)
    asy = _run(tmp_path, "async", "--async-maintain", *flags)
    assert arena["arena_state"] and not tree["arena_state"]
    assert arena["failures"] == tree["failures"] > 0
    assert arena["losses"] == tree["losses"] == asy["losses"]
    assert asy["overhead"]["async_maintains"] == 6
    ca, ct = arena["loop"].controller, tree["loop"].controller
    assert torch.equal(ca._ckpt_arena, ct._ckpt_arena)
    assert torch.equal(asy["loop"].controller._ckpt_arena, ca._ckpt_arena)
    np.testing.assert_array_equal(ca.store.saved_iters(),
                                  ct.store.saved_iters())


def _against_reference(tmp_path, arch):
    jcfg = j_get_config(arch, reduced=True)
    ctx = single_device_ctx()
    jl = JLoop(jcfg, ctx, optimizer=j_adamw(3e-4), loop_cfg=JLoopConfig(
        policy=JPolicy.scar(fraction=0.125, interval=8), fail_prob=0.0,
        fail_fraction=0.5, fabric=JFabric()),
        store=JStore(str(tmp_path / "ref")))
    js = jl.init_state()
    params = jax.tree_util.tree_map(np.asarray, js.params)
    jl.run(js, iter(JDataset(jcfg, batch=2, seq=64, ctx=ctx)), 8)
    got = _run(tmp_path, "port", "--arch", arch, "--steps", "8",
               "--fail-prob", "0", params=params)
    np.testing.assert_allclose(got["losses"],
                               [m["loss"] for m in jl.metrics], rtol=1e-4)
    assert got["saves"] == jl.controller.stats["saves"]
    # the port holds per-layer leaves (other block ids): the stamps, not
    # their positions, compare
    assert (np.unique(got["loop"].controller.store.saved_iters()).tolist()
            == np.unique(jl.controller.store.saved_iters()).tolist())


def test_example_against_reference(tmp_path):
    """The reference example's loop (no failures: the two packages draw
    their lost blocks from different generators) against the port's on
    the reference's initial parameters."""
    _against_reference(tmp_path, "qwen2-1.5b")


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "internvl2-76b"])
def test_example_moe_vlm_against_reference(tmp_path, arch):
    """The MoE and VLM families (the router's aux losses; the patch
    prefix out of the loss) against the reference example's loop, as
    ``test_example_against_reference``."""
    _against_reference(tmp_path, arch)


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "whisper-medium",
                                  "qwen3-moe-235b-a22b", "internvl2-76b"])
def test_example_new_families_arena_pytree_bit_equal(tmp_path, arch):
    flags = ("--arch", arch, "--steps", "4", "--fail-prob", "0.5")
    arena = _run(tmp_path, "arena", *flags)
    tree = _run(tmp_path, "tree", "--pytree", *flags)
    assert arena["arena_state"] and not tree["arena_state"]
    assert arena["failures"] == tree["failures"] > 0
    assert arena["losses"] == tree["losses"]
    assert all(np.isfinite(arena["losses"]))
    ca, ct = arena["loop"].controller, tree["loop"].controller
    assert torch.equal(ca._ckpt_arena, ct._ckpt_arena)

