"""Guards on the port's boundaries.

- No file of ``src/repro_torch/`` and not ``chip_smoke.py`` imports JAX or
  the JAX package (``repro``); ``repro_torch`` itself is allowed.
- Entry points asked for no device run on ``cuda``, and raise where no
  CUDA device is present instead of carrying on on the CPU.
"""
import ast
from pathlib import Path

import pytest
import torch

from repro_torch.core.controller import FTController
from repro_torch.core.policy import CheckpointPolicy
from repro_torch.fabric import CheckpointFabric, FabricConfig
from repro_torch.models.classic import make_model
from repro_torch.training.classic_runner import run_clean, run_with_failure

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module and _forbidden(node.module):
            bad.append(node.module)
    assert not bad, f"{path} imports {bad}"


def test_entry_points_default_to_cuda():
    params = {"w": torch.zeros(4, 2)}
    if torch.cuda.is_available():
        assert make_model("qp").device.type == "cuda"
        with pytest.raises(ValueError):
            FTController(params, CheckpointPolicy.scar())   # params on CPU
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_model("mlr")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FTController(params, CheckpointPolicy.scar())
    cpu_model = make_model("qp", device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_clean(cpu_model, 3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_with_failure(cpu_model, CheckpointPolicy.scar(), fail_iter=1,
                         fail_fraction=0.5, max_iters=3)


def test_model_and_run_devices_must_agree():
    cpu_model = make_model("qp", device="cpu")
    with pytest.raises(ValueError):
        run_clean(cpu_model, 2, device="meta")


def test_fabric_and_store_name_their_roadmap_items():
    """The RS tier and the per-leaf path build; the store, async
    maintenance and the mesh still raise with their ROADMAP items."""
    params = {"w": torch.zeros(4, 2)}
    ctl = FTController(params, CheckpointPolicy.scar(),
                       fabric=FabricConfig(), device="cpu")
    assert ctl.arena_ready and ctl.fabric.arena_layout is not None
    with pytest.raises(NotImplementedError, match="item 11"):
        FTController(params, CheckpointPolicy.scar(), store=object(),
                     device="cpu")
    with pytest.raises(NotImplementedError, match="item 12"):
        FTController(params, CheckpointPolicy.scar(),
                     fabric=FabricConfig(async_maintain=True), device="cpu")
    for cfg, arena in ((FabricConfig(rs_parity=2), True),
                       (FabricConfig(arena=False), False),
                       (FabricConfig(fused=False), False)):
        built = FTController(params, CheckpointPolicy.scar(), fabric=cfg,
                             device="cpu")
        assert built.arena_ready == arena
        assert built.fabric.parity.supports_integrity == (cfg.rs_parity > 0)
    part = ctl.partition
    with pytest.raises(NotImplementedError, match="item 15"):
        CheckpointFabric(part, FabricConfig(), mesh=object())
