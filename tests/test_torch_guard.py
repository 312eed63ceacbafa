"""Guards on the port's boundaries.

- No file of ``src/repro_torch/`` and not ``chip_smoke.py`` imports JAX or
  the JAX package (``repro``); ``repro_torch`` itself is allowed.
- Entry points asked for no device run on ``cuda``, and raise where no
  CUDA device is present instead of carrying on on the CPU; so does
  ``interop.load_parity_rows``.
- No port module writes the environment when it is imported (the
  reference's launch modules set ``XLA_FLAGS`` in their first lines).
"""
import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.checkpoint_io import ShardedCheckpointStore
from repro_torch.configs import get_config
from repro_torch.core.controller import FTController
from repro_torch.core.policy import CheckpointPolicy
from repro_torch.data.synthetic import lm_batch
from repro_torch.examples import (adaptive_checkpoint_policy,
                                  correlated_failures,
                                  priority_vs_random_checkpoints, quickstart,
                                  serve_with_recovery)
from repro_torch.fabric import CheckpointFabric, FabricConfig
from repro_torch.interop import load_parity_rows
from repro_torch.launch.mesh import survivor_mesh
from repro_torch.models import get_model
from repro_torch.models.classic import make_model
from repro_torch.training.classic_runner import run_clean, run_with_failure
from repro_torch.training import TrainLoop, TrainLoopConfig
from repro_torch.training.serve import Server
from repro_torch.utils.tree import flatten_with_path, keystr, tree_leaves

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = (quickstart, priority_vs_random_checkpoints,
            adaptive_checkpoint_policy, correlated_failures,
            serve_with_recovery)
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


def test_entry_points_default_to_cuda(tmp_path):
    params = {"w": torch.zeros(4, 2)}
    lm = {}
    for name in ("mamba2-370m", "qwen2-1.5b"):
        cfg = get_config(name, reduced=True)
        lm[name] = (cfg, get_model(cfg).init_params(
            torch.Generator().manual_seed(0), cfg, device="cpu"))
    # the int8 KV cache's empty cache, asked for no device
    qcfg = dataclasses.replace(get_config("yi-9b", reduced=True),
                               kv_quant=True)
    if torch.cuda.is_available():
        cache = get_model(qcfg).init_cache(qcfg, 2, 16)
        assert {x.device.type for x in cache.values()} == {"cuda"}
        assert cache["k"].dtype == torch.int8
        assert make_model("qp").device.type == "cuda"
        with pytest.raises(ValueError):
            FTController(params, CheckpointPolicy.scar())   # params on CPU
        for script in EXAMPLES:
            assert script.parse_args([]).device is None      # cuda
        for cfg, cpu_params in lm.values():
            gen = torch.Generator().manual_seed(0)
            assert all(x.device.type == "cuda" for x in tree_leaves(
                get_model(cfg).init_params(gen, cfg)))
            with pytest.raises(ValueError):
                Server(cfg, cpu_params)                      # params on CPU
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_model(qcfg).init_cache(qcfg, 2, 16)
    cache = get_model(qcfg).init_cache(qcfg, 2, 16, device="cpu")
    assert cache["k"].dtype == torch.int8 and cache["k"].device.type == "cpu"
    for cfg, cpu_params in lm.values():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            get_model(cfg).init_params(torch.Generator().manual_seed(0), cfg)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            lm_batch(torch.Generator().manual_seed(0), cfg, 2, 4)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Server(cfg, cpu_params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_model("mlr")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FTController(params, CheckpointPolicy.scar())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardedCheckpointStore(str(tmp_path))
    cpu_model = make_model("qp", device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_clean(cpu_model, 3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_with_failure(cpu_model, CheckpointPolicy.scar(), fail_iter=1,
                         fail_fraction=0.5, max_iters=3)
    # the ported example scripts, run with no --device
    for script in EXAMPLES:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            script.main([])


def test_load_parity_rows_defaults_to_cuda():
    """A codec's parity carried in without a device lands on the card, and
    raises where no CUDA device is present; asked for, the CPU."""
    ctl = FTController({"w": torch.zeros(4, 2)}, CheckpointPolicy.scar(),
                       fabric=FabricConfig(), device="cpu")
    codec = ctl.fabric.parity
    rows = np.zeros((codec.n_groups, codec.layout.frame_elems), np.int32)
    if torch.cuda.is_available():
        load_parity_rows(codec, rows, 1)
        assert codec.parity.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            load_parity_rows(codec, rows, 1)
    load_parity_rows(codec, rows, 2, device="cpu")
    assert codec.parity.device.type == "cpu" and codec.encoded_step == 2


def test_new_families_default_to_cuda():
    """The hybrid and encoder-decoder families' ``init_params`` and
    ``init_cache`` run on the card unless asked otherwise, and raise where
    no CUDA device is present."""
    for name in ("zamba2-1.2b", "whisper-medium"):
        cfg = get_config(name, reduced=True)
        ops = get_model(cfg)
        if torch.cuda.is_available():
            assert all(x.device.type == "cuda" for x in tree_leaves(
                ops.init_params(torch.Generator().manual_seed(0), cfg)))
            assert all(x.device.type == "cuda" for x in tree_leaves(
                ops.init_cache(cfg, 2, 8)))
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                ops.init_params(torch.Generator().manual_seed(0), cfg)
            with pytest.raises(RuntimeError, match="no CUDA device"):
                ops.init_cache(cfg, 2, 8)
        assert all(x.device.type == "cpu" for x in tree_leaves(
            ops.init_cache(cfg, 2, 8, device="cpu")))


def test_trainer_names_item_29_for_the_new_families():
    """Training the hybrid and encoder-decoder families (ROADMAP item 29)
    and the MoE and VLM families (item 31) is ported: each family's
    ``TrainLoop`` builds, runs on the card unless asked otherwise and
    raises where no CUDA device is present; asked for, the CPU; its
    per-layer leaves split each stacked subtree of the family, every
    attention's ``wo`` and every MoE block's expert stacks are held 2-D.
    No file of the port still names item 31."""
    for name, stacked in (("zamba2-1.2b", ["layers"]),
                          ("whisper-medium", ["enc_layers", "dec_layers"]),
                          ("qwen3-moe-235b-a22b", ["layers"]),
                          ("llama4-maverick-400b-a17b", ["layers"]),
                          ("internvl2-76b", ["layers"])):
        cfg = get_config(name, reduced=True)
        if torch.cuda.is_available():
            assert TrainLoop(cfg).device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                TrainLoop(cfg)
        loop = TrainLoop(cfg, device="cpu")
        assert loop.device.type == "cpu"
        assert [k for k, _ in loop.ops.stacked_layers] == stacked
        state = loop.init_state()
        for key in stacked:
            assert isinstance(state.params[key], list)
        assert all(x.device.type == "cpu"
                   for x in tree_leaves(state.params))
        named = [(keystr(p), x)
                 for p, x in flatten_with_path(state.params)[0]]
        wo = [x for k, x in named if k.endswith("['wo']")]
        assert wo and all(x.shape == (cfg.n_heads * cfg.head_dim,
                                      cfg.d_model) for x in wo)
        experts = [x for k, x in named if "_experts']" in k]
        e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
        assert all(x.shape in ((e * d, f), (e * f, d)) for x in experts)
        n_moe = (cfg.n_layers // cfg.moe_every) if cfg.n_experts else 0
        assert len(experts) == 3 * n_moe
    for path in FILES:
        assert "item 31" not in path.read_text(), path


def test_model_and_run_devices_must_agree():
    cpu_model = make_model("qp", device="cpu")
    with pytest.raises(ValueError):
        run_clean(cpu_model, 2, device="meta")


def test_fabric_and_store_name_their_roadmap_items(tmp_path):
    """The RS tier, the per-leaf path, the store (item 11) and async
    maintenance (item 12) build and run; the mesh (item 15) is ported and
    raises for a mesh whose size is not the fabric's device count and for
    an object that is not a mesh."""
    params = {"w": torch.zeros(4, 2)}
    ctl = FTController(params, CheckpointPolicy.scar(),
                       fabric=FabricConfig(), device="cpu")
    assert ctl.arena_ready and ctl.fabric.arena_layout is not None
    store = ShardedCheckpointStore(str(tmp_path), device="cpu")
    with_store = FTController(params, CheckpointPolicy.scar(0.5, 2),
                              store=store, device="cpu")
    with_store.checkpoint_now(1, {"w": torch.ones(4, 2)})
    store.flush()
    assert torch.equal(store.read_all()["w"], with_store.ckpt.values["w"])
    asy = FTController(params, CheckpointPolicy.scar(),
                       fabric=FabricConfig(async_maintain=True), device="cpu")
    asy.maintain(1, asy.pack_live(params))
    assert asy.fabric.has_pending_maintenance
    asy.fabric.block_until_maintained()
    assert asy.fabric.stats["async_maintains"] == 1
    for cfg, arena in ((FabricConfig(rs_parity=2), True),
                       (FabricConfig(arena=False), False),
                       (FabricConfig(fused=False), False)):
        built = FTController(params, CheckpointPolicy.scar(), fabric=cfg,
                             device="cpu")
        assert built.arena_ready == arena
        assert built.fabric.parity.supports_integrity == (cfg.rs_parity > 0)
    part = ctl.partition
    with pytest.raises(TypeError, match="Mesh"):
        CheckpointFabric(part, FabricConfig(), mesh=object())
    with pytest.raises(ValueError, match="mesh has 1 devices"):
        CheckpointFabric(part, FabricConfig(), mesh=survivor_mesh([0]))
    assert CheckpointFabric(part, FabricConfig(n_devices=1),
                            mesh=survivor_mesh([0])).arena_layout.shards == 1


def test_trainer_defaults_to_cuda_and_names_its_roadmap_items(tmp_path):
    """The LM trainer runs on the card unless asked otherwise, and raises
    where no CUDA device is present; with a store and async maintenance
    (items 11 and 12) it builds and runs; ``elastic_mesh=True`` without a
    mesh raises; ``moe_block`` on a one-rank mesh is the ctx-less call
    (the expert-parallel MoE, item 38, is ported) and no port file names
    items 15, 38, 39 (the other families' tensor parallelism), 40 (the
    server on a mesh), 41 (query heads that do not split over the model
    axis), 42 (the mesh step's whole-arena gather), 46 (the per-layer
    gather over the data line) or 47 (the residual stream between layers
    split over the model axis) any more."""
    from repro_torch.data import ShardedLMDataset
    cfg = get_config("qwen2-1.5b", reduced=True)
    if torch.cuda.is_available():
        assert TrainLoop(cfg).device.type == "cuda"
        assert ShardedLMDataset(cfg, 2, 4).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TrainLoop(cfg)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ShardedLMDataset(cfg, 2, 4)
    assert TrainLoop(cfg, device="cpu").device.type == "cpu"
    store = ShardedCheckpointStore(str(tmp_path), device="cpu")
    loop = TrainLoop(cfg, loop_cfg=TrainLoopConfig(
        policy=CheckpointPolicy.scar(0.25, 4),
        fabric=FabricConfig(async_maintain=True)), store=store, device="cpu")
    from repro_torch.data import ShardedLMDataset as DS
    state = loop.run(loop.init_state(), iter(DS(cfg, 2, 8, device="cpu")), 1)
    assert loop.controller.store is store
    assert loop.controller.fabric.stats["async_maintains"] == 1
    assert not loop.controller.fabric.has_pending_maintenance
    # the elastic mesh (item 15) is ported: asked for without a mesh it
    # is a configuration error at run(), not a silent no-op
    loop = TrainLoop(cfg, loop_cfg=TrainLoopConfig(
        policy=CheckpointPolicy.scar(0.25, 4), elastic_mesh=True,
        fabric=FabricConfig(elastic=True)), device="cpu")
    with pytest.raises(ValueError, match="elastic_mesh=True"):
        loop.run(loop.init_state(), iter(DS(cfg, 2, 8, device="cpu")), 1)
    from repro_torch.models.layers import init_moe, moe_block
    from repro_torch.sharding.partition import make_dist_ctx
    moe_cfg = get_config("qwen3-moe-235b-a22b", reduced=True)
    p = init_moe(torch.Generator().manual_seed(0), moe_cfg, torch.float32,
                 "cpu")
    x = torch.randn((1, 6, moe_cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    o0, aux0 = moe_block(x, p, moe_cfg)
    o1, aux1 = moe_block(x, p, moe_cfg, make_dist_ctx(survivor_mesh([0])))
    assert torch.equal(o0, o1)
    assert all(torch.equal(a, b) for a, b in zip(aux0, aux1))
    for path in FILES:
        text = path.read_text()
        assert "ROADMAP item 15" not in text, path
        assert "ROADMAP item 38" not in text and "item 38" not in text, path
        assert "item 39" not in text, path
        assert "item 40" not in text, path
        assert "item 41" not in text, path
        assert "item 42" not in text, path
        assert "item 46" not in text, path
        assert "item 47" not in text, path


def _env_writes(tree: ast.Module) -> list:
    """The module-level statements of ``tree`` that write ``os.environ``
    (an item assigned or deleted, ``update``, ``setdefault``, ``pop``) or
    call ``os.putenv``."""
    def environ(node) -> bool:
        return (isinstance(node, ast.Attribute) and node.attr == "environ") \
            or (isinstance(node, ast.Name) and node.id == "environ")
    bad = []
    for stmt in tree.body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            continue
        for node in ast.walk(stmt):
            targets = []
            if isinstance(node, (ast.Assign, ast.Delete)):
                targets = node.targets
            elif isinstance(node, ast.AugAssign):
                targets = [node.target]
            if any(isinstance(t, ast.Subscript) and environ(t.value)
                   for t in targets):
                bad.append(node.lineno)
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) and (
                        (environ(node.func.value) and node.func.attr in (
                            "update", "setdefault", "pop"))
                        or node.func.attr == "putenv"):
                bad.append(node.lineno)
    return bad


@pytest.mark.parametrize("path", FILES[:-1],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_environment_writes_at_import(path):
    """No port module, the launch analytics (``launch/dryrun.py``,
    ``launch/roofline.py``, ``launch/perf.py``) among them, writes the
    environment when it is imported (``chip_smoke.py``, a script that is
    run, sets cuBLAS's workspace before CUDA starts)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    assert not _env_writes(tree), f"{path}: lines {_env_writes(tree)}"


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_xla_flags_and_no_open_launch_item(path):
    """No port file names ``XLA_FLAGS``, and none names the launch
    analytics' ROADMAP item (17) now that it is ported."""
    text = path.read_text()
    assert "XLA_FLAGS" not in text, path
    assert "item 17" not in text, path


def test_slice_exchange_modules_are_scanned():
    """The slice plan, its exchange and the step that runs them are among
    the files the import guard reads."""
    names = {str(p.relative_to(ROOT)) for p in FILES}
    for mod in ("sharding/partition", "distributed/collectives",
                "training/step", "launch/dryrun"):
        assert f"src/repro_torch/{mod}.py" in names


def test_launch_modules_are_scanned():
    names = {str(p.relative_to(ROOT)) for p in FILES}
    for mod in ("dryrun", "roofline", "perf"):
        assert f"src/repro_torch/launch/{mod}.py" in names


def _imports(path: Path) -> set:
    """The top-level names of the modules a file imports (absolute
    imports), and of each ``from`` import its full module."""
    got = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            got |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            got.add(node.module)
    return got


def test_sequence_parallel_modules_are_scanned():
    """Every port module that ``tests/test_torch_mesh_seq_split.py``
    imports, and every module the sequence-parallel carry runs through, is
    among the files the import guard reads and imports neither JAX nor the
    reference (``chip_smoke.py`` neither); the carry's modules compute
    with torch."""
    names = {str(p.relative_to(ROOT)) for p in FILES}
    test = _imports(ROOT / "tests" / "test_torch_mesh_seq_split.py")
    assert {"jax", "torch", "numpy"} <= {m.split(".")[0] for m in test}
    carry = {f"repro_torch.{m}" for m in (
        "models.layers", "models.transformer", "models.ssm",
        "models.hybrid", "models.encdec", "distributed.collectives",
        "sharding.partition", "training.step", "launch.dryrun")}
    for mod in sorted(carry | {m for m in test
                               if m.startswith("repro_torch.")}):
        rel = "src/" + mod.replace(".", "/")
        path = f"{rel}.py" if f"{rel}.py" in names else f"{rel}/__init__.py"
        assert path in names, mod
        got = {m.split(".")[0] for m in _imports(ROOT / path)}
        assert mod not in carry or "torch" in got, path
        assert not {m for m in got if _forbidden(m)}, path
    assert not {m for m in _imports(ROOT / "chip_smoke.py")
                if _forbidden(m)}
