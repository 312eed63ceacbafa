"""The fabric-less SCAR loop of every classic model on the card, held to
the same loop on the CPU.

Every test here is marked ``gpu`` and skips where there is no CUDA device.
The file imports neither JAX nor the JAX package:

    python -m pytest -q --noconftest -m gpu tests/test_torch_models_gpu.py

Both runs draw the same batches and the same failure mask (CPU
generators). Losses agree within rtol 1e-3: the card sums matmuls,
convolutions and scores in another order than the CPU, and 40 iterations
compound it. Iteration costs agree within one iteration, for a threshold
crossing that the rounding can move.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core.policy import CheckpointPolicy
from repro_torch.kernels import _build
from repro_torch.models.classic import make_model
from repro_torch.training.classic_runner import run_clean, run_with_failure

SIZES = {
    "qp": dict(dim=6),
    "mlr": dict(n=400, dim=64, n_classes=5, batch=100),
    "mf": dict(m=120, n=160, rank=3),
    "lda": dict(n_docs=30, vocab=60, n_topics=5, doc_len_mean=20),
    "cnn": dict(n=64, size=8, batch=16),
}
ITERS = 40


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def _run(name, device, policy):
    model = make_model(name, device=device, **SIZES[name])
    clean = run_clean(model, ITERS, device=device)["losses"]
    res = run_with_failure(model, policy, fail_iter=10, fail_fraction=0.5,
                           max_iters=ITERS, clean_losses=clean, device=device)
    return model, clean, res


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(SIZES))
def test_scar_loop_on_the_card_matches_the_cpu(cuda, name):
    policy = dataclasses.replace(CheckpointPolicy.scar(0.25, 8), block_rows=8)
    _build.reset_launches()
    gpu_model, gpu_clean, gpu = _run(name, cuda, policy)
    launches = dict(_build.LAUNCHES)
    cpu_model, cpu_clean, cpu = _run(name, "cpu", policy)
    assert np.all(np.isfinite(gpu["losses"]))
    np.testing.assert_allclose(gpu_clean, cpu_clean, rtol=1e-3)
    np.testing.assert_allclose(gpu["losses"], cpu["losses"], rtol=1e-3)
    assert abs(gpu["iteration_cost"] - cpu["iteration_cost"]) <= 1
    assert launches["block_dist"] > 0 and launches["masked_restore"] > 0
    assert launches["scatter_save"] > 0


@pytest.mark.gpu
def test_out_of_place_save_on_the_card_matches_the_cpu(cuda):
    """``inplace_save=False`` saves through select_blocks, which is the
    masked_restore kernel on the card."""
    from repro_torch.core.controller import FTController
    from repro_torch.utils.tree import tree_leaves
    rng = np.random.default_rng(0)
    shapes = {"w": (37, 6), "b": (6,), "e": (64, 4)}
    trees = [{k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(4)]
    policy = CheckpointPolicy(fraction=0.3, full_interval=3, block_rows=8)
    ctls = {}
    for dev in (cuda, torch.device("cpu")):
        p0 = {k: torch.from_numpy(v).to(dev) for k, v in trees[0].items()}
        ctls[dev.type] = FTController(p0, policy, inplace_save=False,
                                      device=dev)
    n0 = _build.LAUNCHES["masked_restore"]
    for step, t in enumerate(trees[1:], start=1):
        masks = {dev: ctl.checkpoint_now(
            step, {k: torch.from_numpy(v).to(ctl.device)
                   for k, v in t.items()}) for dev, ctl in ctls.items()}
        assert torch.equal(masks["cuda"].cpu(), masks["cpu"])
    assert _build.LAUNCHES["masked_restore"] > n0
    for g, c in zip(tree_leaves(ctls["cuda"].ckpt.values),
                    tree_leaves(ctls["cpu"].ckpt.values)):
        assert torch.equal(g.cpu(), c)
