"""The launch analytics (``repro_torch.launch.{dryrun,roofline,perf}``)
against the reference's ``repro.launch`` helpers.

The reference's three modules append ``--xla_force_host_platform_device_
count=512`` to ``XLA_FLAGS`` as their first statement. This file reads
``jax.device_count()`` before importing them, restores ``XLA_FLAGS`` after,
and holds the count unchanged (as ``tests/test_dryrun_helpers.py``
imports them, JAX's backend is made before the flag is read).

- ``applicable`` for every config x shape, and the port's own skips: none
  on the ``(16, 16)`` mesh, a split that crosses kv groups unevenly
  elsewhere;
  ``shape_params`` and ``input_specs``' shapes and dtypes;
- ``count_params`` (total and active, exact, every config at full width;
  the reference through ``jax.eval_shape``), ``model_flops`` and
  ``attention_cost``; ``roofline_terms`` under the reference's TPU
  figures, bit for bit;
- the meta run's ``flops``, ``bytes_accessed`` and collectives equal to
  the same rank step on real CPU tensors, at reduced configs, for train,
  prefill and decode;
- the depth probes' extrapolation equal to a full-depth meta count, for
  every family's probe rule (dense, the interleaved MoE pair, the hybrid,
  the encoder-decoder);
- the counting stand-in's calls and bytes per collective equal to
  ``collectives.STATS`` of a real 4-rank ``(2, 2)`` gloo job running the
  same reduced step (in subprocesses, as ``tests/test_torch_mesh_tp.py``),
  the train step's grouped slice gathers and reduces (an interleaved MoE
  model's dense and MoE layers, the hybrid's shared block in the outer
  group) among them.
"""
import dataclasses
import json
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

N_DEVICES = jax.device_count()
_FLAGS = os.environ.get("XLA_FLAGS")
from repro.configs import get_config as jget  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.launch import dryrun as jdry  # noqa: E402
from repro.launch import roofline as jroof  # noqa: E402
if _FLAGS is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _FLAGS

from repro_torch.configs import get_config, list_configs  # noqa: E402
from repro_torch.configs.base import _REGISTRY, register  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.distributed import collectives  # noqa: E402
from repro_torch.launch import dryrun, perf, roofline  # noqa: E402
from repro_torch.launch.mesh import (make_dry_mesh,  # noqa: E402
                                     make_dry_production_mesh)

SRC = Path(__file__).resolve().parents[1] / "src"
ALL_SHAPES = dryrun.SHAPES + ["smoke_train", "smoke_decode"]
DEADLINE = 120
# reduced configs, f32, for the meta-against-real and the probe checks
REDUCED = ("qwen2-1.5b", "qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b",
           "zamba2-1.2b", "whisper-medium", "mamba2-370m", "internvl2-76b")
KINDS = (("train", 4, 32), ("prefill", 4, 32), ("decode", 4, 32))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_reference_import_leaves_the_device_count():
    assert jax.device_count() == N_DEVICES
    assert os.environ.get("XLA_FLAGS") == _FLAGS


@pytest.mark.parametrize("name", list_configs())
def test_applicable_and_the_ports_own_skips(name):
    cfg, jcfg = get_config(name), jget(name)
    mesh = make_dry_production_mesh()
    for shape in dryrun.SHAPES:
        assert dryrun.applicable(cfg, shape) == jdry.applicable(jcfg, shape)
    # the port skips none of the repo's configs at (16, 16): query heads
    # that do not split take whole-head ranges (llama4-maverick's 40 and
    # qwen2-1.5b's 12 over 16)
    assert dryrun.port_applicable(cfg, mesh) == (True, "")
    # a (4, 4) mesh takes qwen2-1.5b (12/2 heads: 3 query heads over one
    # shared kv head a rank)
    if name == "qwen2-1.5b":
        assert dryrun.port_applicable(
            cfg, make_dry_mesh((4, 4), ("data", "model")))[0]
    # a split whose ranges cross kv groups unevenly is still the port's
    # own skip: llama4-maverick's 40/8 heads at 3 (position 0's [0, 14))
    if name == "llama4-maverick-400b-a17b":
        ok, why = dryrun.port_applicable(
            cfg, make_dry_mesh((1, 3), ("data", "model")))
        assert not ok
        assert why.startswith("port:") and "n_heads" in why \
            and "[0, 14)" in why
        assert not any(why == jdry.applicable(jcfg, s)[1]
                       for s in dryrun.SHAPES)
    assert dryrun.SHAPES == jdry.SHAPES


@pytest.mark.parametrize("name", list_configs())
def test_shape_params_and_input_specs(name):
    cfg, jcfg = get_config(name), jget(name)
    for shape in ALL_SHAPES:
        assert tsyn.shape_params(shape) == jsyn.shape_params(shape)
        got = tsyn.input_specs(cfg, shape)
        want = jsyn.input_specs(jcfg, shape)
        assert sorted(got) == sorted(want), shape
        for k, w in want.items():
            assert got[k].device.type == "meta"
            assert tuple(got[k].shape) == tuple(w.shape), (shape, k)
            assert str(got[k].dtype).split(".")[-1] == str(w.dtype), k


@pytest.mark.parametrize("name", list_configs())
def test_count_params_model_flops_and_attention_cost(name):
    cfg, jcfg = get_config(name), jget(name)
    assert roofline.count_params(cfg) == jroof.count_params(jcfg)
    for shape in ALL_SHAPES:
        assert roofline.model_flops(cfg, shape) == jroof.model_flops(
            jcfg, shape)
        for tri in (False, True):
            c = dataclasses.replace(cfg, triangle_prefill=tri)
            j = dataclasses.replace(jcfg, triangle_prefill=tri)
            assert roofline.attention_cost(c, shape) \
                == jroof.attention_cost(j, shape), (shape, tri)


def test_roofline_terms_under_the_reference_figures():
    spec = roofline.TPU_V5E
    assert (spec.chips, spec.peak_flops, spec.hbm_bw, spec.link_bw) == (
        jroof.CHIPS, jroof.PEAK_FLOPS, jroof.HBM_BW, jroof.ICI_BW)
    rng = np.random.default_rng(0)
    for f, b, c in rng.uniform(0, 1e16, (20, 3)):
        assert roofline.roofline_terms(f, b, c, spec) \
            == jroof.roofline_terms(f, b, c)
    assert roofline.WHAT_MOVES == jroof.WHAT_MOVES
    h = roofline.H100
    assert (h.peak_flops, h.hbm_bw, h.link_bw) == (989e12, 3.35e12, 450e9)


def _reduced(name: str, **over):
    """A reduced config registered under a name of its own (the probes
    read configs by name), f32."""
    cfg = dataclasses.replace(get_config(name, reduced=True),
                              name=f"reduced-{name}", **over)
    register(cfg)
    return cfg.name


@pytest.fixture(scope="module", autouse=True)
def _registry():
    before = dict(_REGISTRY)
    yield
    _REGISTRY.clear()
    _REGISTRY.update(before)


@pytest.mark.parametrize("name", REDUCED)
def test_meta_counts_equal_the_real_cpu_step(name):
    """The same rank step (position 3 of a dry (2, 2) mesh) on meta and on
    CPU tensors: the same FLOPs, bytes, collectives and argument bytes."""
    cfg = get_config(_reduced(name))
    mesh = make_dry_mesh((2, 2), ("data", "model"), position=3)
    for kind, b, s in KINDS:
        got = {}
        for dev in ("meta", "cpu"):
            step = dryrun.build_rank_step(cfg, kind, b, s, mesh, dev)
            got[dev] = dryrun.measure(step)
        m, c = got["meta"], got["cpu"]
        assert m["flops"] == c["flops"] > 0, kind
        assert m["bytes_accessed"] == c["bytes_accessed"] > 0, kind
        assert m["collectives"] == c["collectives"], kind
        assert m["collectives"]["total_bytes"] > 0, kind
        assert m["memory"]["argument_bytes"] == \
            c["memory"]["argument_bytes"], kind
        # a 0-d tensor made by torch.tensor (the prefill cache's pos) is
        # tracked on one device and not the other: 4 bytes
        for k in ("output_bytes", "temp_bytes"):
            assert abs(m["memory"][k] - c["memory"][k]) <= 16, (kind, k)


@pytest.mark.parametrize("name,over,full", (
    ("qwen2-1.5b", {}, dict(n_layers=3)),
    ("llama4-maverick-400b-a17b", {}, dict(n_layers=6)),
    ("zamba2-1.2b", {}, dict(n_layers=5, attn_every=2)),
    ("whisper-medium", {}, dict(n_layers=3, enc_layers=3))),
    ids=("dense", "moe_pair", "hybrid", "audio"))
def test_depth_probes_extrapolate_to_the_full_depth(name, over, full):
    arch = _reduced(name, **full)
    mesh = make_dry_mesh((2, 2), ("data", "model"))
    for shape in ("smoke_train", "smoke_decode"):
        corr = roofline.corrected_costs(dryrun.dry_record(arch, shape,
                                                          mesh))
        whole = dryrun.probe(arch, shape, mesh, microbatch=1)
        assert corr["flops"] == whole["flops"] > 0, shape
        for k in ("bytes", "coll"):
            if shape == "smoke_decode":
                assert corr[k] == whole[k] > 0, (shape, k)
            else:
                # the arena's tile alignment: under two tiles a shard
                assert corr[k] == pytest.approx(whole[k], rel=1e-3), k
        plan, _ = dryrun.probe_plan(get_config(arch))
        assert len(plan) == (3 if name in ("zamba2-1.2b", "whisper-medium")
                             else 2)


def test_dry_run_record_and_the_pairs(tmp_path):
    """A record of the reduced qwen3-moe on a dry (2, 2) mesh carries the
    reference's keys; the analyses behind the pairs read it."""
    arch = _reduced("qwen3-moe-235b-a22b", n_layers=3)
    mesh = make_dry_mesh((2, 2), ("data", "model"))
    costs, meta = dryrun.lower_combination(arch, "smoke_train", mesh)
    assert meta["step"] == "train_step" and meta["param_dtype"] == "float32"
    assert set(costs["collectives"]) == set(collectives.KINDS) \
        | {"total_bytes"}
    assert set(costs["memory"]) >= {"argument_bytes", "output_bytes",
                                    "temp_bytes"}
    base = roofline.analyze(arch, "smoke_train", mesh, None)
    opt = roofline.analyze(arch, "smoke_train", mesh, None,
                           overrides={"moe_reduce_scatter": True})
    rec = perf.pair_record("B", base, opt)
    assert set(rec) == {"pair", "arch", "shape", "term", "overrides",
                        "baseline", "optimized",
                        "dominant_term_improvement_pct"}
    # the reduce-scatter route gathers the sum back: it moves no fewer
    # bytes than the all-reduce
    assert rec["dominant_term_improvement_pct"] <= 0.0


def test_roofline_reads_the_dry_run_record(tmp_path, monkeypatch):
    """The roofline reads a record the dry run wrote and probes nothing
    again; a train step that accumulates keeps its counts at microbatch
    1, which the roofline reads."""
    arch = _reduced("zamba2-1.2b", n_layers=3, attn_every=2, microbatch=2)
    mesh = make_dry_mesh((1, 2), ("data", "model"))
    rec = dryrun.dry_record(arch, "smoke_train", mesh)
    assert rec["ok"] and rec["mesh"] == "mesh1x2", rec.get("error")
    assert get_config(arch).microbatch > 1 and "microbatch1" in rec
    one = dryrun.dry_record(arch, "smoke_train", mesh,
                            overrides={"microbatch": 1})
    assert "microbatch1" not in one
    assert rec["microbatch1"]["flops"] == one["flops"]
    assert rec["microbatch1"]["bytes"] == one["bytes_accessed"]
    path = dryrun.record_path(str(tmp_path), arch, "smoke_train",
                              rec["mesh"])
    with open(path, "w") as f:
        json.dump(rec, f)

    def no_probe(*a, **k):
        raise AssertionError("probed again")
    monkeypatch.setattr(dryrun, "depth_costs", no_probe)
    got = roofline.analyze(arch, "smoke_train", mesh, str(tmp_path))
    assert got["hlo_flops_raw_per_device"] == rec["flops"]
    assert got["hlo_flops_corrected_per_device"] == one["flops"]
    assert got["temp_bytes_per_device"] == rec["memory"]["temp_bytes"]


RANK = r'''
import dataclasses, datetime, pickle, sys
import torch
import torch.distributed as dist

torch.set_num_threads(1)
rank, world, rdv, out = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                         sys.argv[4])
dist.init_process_group("gloo", init_method=f"file://{rdv}", rank=rank,
                        world_size=world,
                        timeout=datetime.timedelta(seconds=90))
from repro_torch.configs import get_config
from repro_torch.distributed import collectives
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_host_mesh

collectives.CHUNK_BYTES = 1 << 16
mesh = make_host_mesh(model=2)
res = {"rank": rank, "position": mesh.position()}
for name in %(names)r:
    cfg = get_config(name, reduced=True)
    for kind, b, s in %(kinds)r:
        step = dryrun.build_rank_step(cfg, kind, b, s, mesh, "cpu")
        rec = dryrun.measure(step)
        res[(name, kind)] = {k: (v["calls"], v["bytes"])
                             for k, v in rec["stats"].items()}
        res[(name, kind, "result")] = {k: v.get("result_bytes")
                                       for k, v in rec["stats"].items()}
pickle.dump(res, open(f"{out}/rank_{rank}.pkl", "wb"))
dist.destroy_process_group()
'''
GLOO_NAMES = ("qwen2-1.5b", "qwen3-moe-235b-a22b",
              "llama4-maverick-400b-a17b", "zamba2-1.2b")


@pytest.fixture(scope="module")
def gloo_job(tmp_path_factory):
    out = tmp_path_factory.mktemp("launch_gloo")
    (out / "rank.py").write_text(RANK % {"names": GLOO_NAMES,
                                         "kinds": KINDS})
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1",
               GLOO_SOCKET_IFNAME="lo")
    procs = [subprocess.Popen(
        [sys.executable, str(out / "rank.py"), str(r), "4", str(out / "rdv"),
         str(out)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(4)]
    end = time.monotonic() + DEADLINE
    logs = []
    try:
        for p in procs:
            o, _ = p.communicate(timeout=max(1.0, end - time.monotonic()))
            logs.append(o)
    except subprocess.TimeoutExpired:
        pytest.fail(f"the ranks did not finish in {DEADLINE} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
    return [pickle.load(open(out / f"rank_{r}.pkl", "rb")) for r in range(4)]


@pytest.mark.parametrize("kind", [k[0] for k in KINDS])
@pytest.mark.parametrize("name", GLOO_NAMES)
def test_counting_stand_in_equals_a_real_gloo_job(gloo_job, name, kind):
    b, s = next((b, s) for k, b, s in KINDS if k == kind)
    cfg = get_config(name, reduced=True)
    for r in gloo_job:
        mesh = make_dry_mesh((2, 2), ("data", "model"),
                             position=r["position"])
        step = dryrun.build_rank_step(cfg, kind, b, s, mesh, "meta")
        dry = dryrun.measure(step)
        got = {k: (v["calls"], v["bytes"]) for k, v in dry["stats"].items()}
        assert got == r[(name, kind)], r["rank"]
        assert sum(v[1] for v in got.values()) > 0


@pytest.mark.parametrize("method", ("slice_gather", "slice_reduce"))
@pytest.mark.parametrize("name", GLOO_NAMES)
def test_counting_stand_in_slice_exchange_equals_a_real_gloo_job(
        gloo_job, name, method):
    """The train step's two slice collectives: the stand-in's calls,
    bytes and result bytes equal a real rank's; the gathers' results are
    4 B a value of the rank's slices, the outer group's once and each
    layer's twice (the forward and its recompute), and the reduces land
    4 B a word of the rank's span that a group's leaves hold."""
    from repro_torch.sharding.partition import SlicePlan
    b, s = next((b, s) for k, b, s in KINDS if k == "train")
    cfg = get_config(name, reduced=True)
    for r in gloo_job:
        mesh = make_dry_mesh((2, 2), ("data", "model"),
                             position=r["position"])
        step = dryrun.build_rank_step(cfg, "train", b, s, mesh, "meta")
        dry = dryrun.measure(step)["stats"][method]
        real = r[(name, "train")][method]
        plan = step.info["slice_plan"]
        layers = range(1, plan.n_groups)
        assert len(layers) == cfg.n_layers
        assert (dry["calls"], dry["bytes"]) == real
        assert real[0] == (1 + 2 * len(layers) if method == "slice_gather"
                           else 1 + len(layers))
        assert dry["result_bytes"] == r[(name, "train", "result")][method]
        if method == "slice_gather":
            want = plan.group_values(0) + 2 * sum(plan.group_values(g)
                                                  for g in layers)
        else:
            want = sum(plan.owned_words(plan.pos, g)
                       for g in range(plan.n_groups))
        assert dry["result_bytes"] == 4 * want > 0


def test_train_probe_gathers_the_slices_alone():
    """granite-8b's depth-1 train probe on rank 0 of the dry (16, 16)
    mesh: the gathers' results are 4 B a value of the rank's model
    slices, the layer's twice (the forward and its recompute), a
    fifteenth of the arena's words or less; the reduces land the rank's
    span, 4 B a word that a leaf holds."""
    mesh = make_dry_production_mesh()
    rec = dryrun.probe("granite-8b", "train_4k", mesh, n_layers=1)
    cfg = dataclasses.replace(get_config("granite-8b"), n_layers=1)
    step = dryrun.build_rank_step(cfg, "train", 2, 8, mesh, "meta")
    plan = step.info["slice_plan"]
    gather = rec["collectives"]["all-gather"]
    values = plan.group_values(0) + plan.group_values(1)
    assert plan.n_groups == 2 and gather["count"] == 3
    assert 4 * values == 157_335_552
    assert gather["bytes"] == 4 * (plan.group_values(0)
                                   + 2 * plan.group_values(1))
    assert 15 * values < step.info["arena_words"]
    assert rec["collectives"]["reduce-scatter"]["count"] == 2
    assert rec["collectives"]["reduce-scatter"]["bytes"] == 4 * sum(
        plan.owned_words(0, g) for g in (0, 1)) <= 4 * plan.shard_words

