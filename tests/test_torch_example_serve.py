"""The ported ``examples/serve_with_recovery.py``
(``python -m repro_torch.examples.serve_with_recovery``) against the
reference's script, on the CPU at its default size (reduced configs, batch
4, a 32-token prompt, 8 new tokens), for every family: dense (``yi-9b``,
the default), MoE (qwen3-moe; llama4-maverick, dense and MoE layers
interleaved), VLM (internvl2, its prompts carrying patches), ssm, hybrid
and audio.

The reference's ``main()`` runs in this process and its printed tokens
are parsed; the port's ``run`` is handed the script's own draws as numpy:
the weights (``init_params(PRNGKey(0))``), the prompts (``lm_batch(
PRNGKey(1))``, patches and frames included) and the lost blocks (the reference
controller's first ``sample_failure(0.3)``). Held exactly: the tokens
before and after the recovery, the lost blocks, a lossless restore.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core.controller import FTController as JController
from repro.core.policy import CheckpointPolicy as JPolicy
from repro.data import lm_batch as j_lm_batch
from repro.models import get_model as j_get_model
from repro_torch.examples import serve_with_recovery

from reference_examples import find, reference_output


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


SERVE_ARCHS = ["yi-9b", "qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b",
               "internvl2-76b", "mamba2-370m", "zamba2-1.2b",
               "whisper-medium"]


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_serve_with_recovery_against_reference(arch):
    """The reference script's weights, prompts and lost blocks (drawn as
    it draws them) carried in: the same tokens before and after, the same
    number of lost blocks, a lossless restore."""
    text, _ = reference_output("serve_with_recovery", ["--arch", arch])
    jcfg = j_get_config(arch, reduced=True)
    params = j_get_model(jcfg).init_params(jax.random.PRNGKey(0), jcfg)
    batch = j_lm_batch(jax.random.PRNGKey(1), jcfg, 4, 32)
    lost = JController(params, JPolicy.scar(fraction=1.0, interval=1)
                       ).sample_failure(0.3)
    args = serve_with_recovery.parse_args(["--arch", arch, "--device", "cpu"])
    got = serve_with_recovery.run(args, _np(params), _np(batch),
                                  [np.nonzero(np.asarray(lost))[0]],
                                  verbose=False)
    before = find(r"tokens \(before failure\): \[([^\]]*)\]", text)[0]
    after = find(r"tokens \(after recovery\):\s+\[([^\]]*)\]", text)[0]
    assert got["tokens_before"][0].tolist() == [int(t) for t in
                                                before.split()]
    assert got["tokens_after"][0].tolist() == [int(t) for t in after.split()]
    assert got["identical"]
    assert got["info"]["lost_blocks"] == float(
        find(r"lost (\d+) blocks", text)[0])
    assert got["info"]["applied_sq"] == 0.0


def test_serve_with_recovery_names_item_19_for_moe_and_vlm(tmp_path):
    """ROADMAP item 19 is in: the example serves the MoE and VLM
    configurations from its own seeded draws, identical tokens after the
    lossless recovery; training them (item 31) is in too, and the
    training example trains each at ``--tiny``."""
    from repro_torch.examples import train_lm_with_failures
    for arch in ("qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b",
                 "internvl2-76b"):
        args = serve_with_recovery.parse_args(["--arch", arch,
                                               "--device", "cpu"])
        got = serve_with_recovery.run(args, verbose=False)
        assert got["identical"] and got["tokens_before"].shape == (4, 8)
        assert got["info"]["lost_blocks"] > 0
        args = train_lm_with_failures.parse_args(
            ["--tiny", "--arch", arch, "--steps", "2", "--device", "cpu"])
        trained = train_lm_with_failures.train(args, str(tmp_path / arch),
                                               verbose=False)
        assert len(trained["losses"]) == 2
        assert all(np.isfinite(trained["losses"]))
