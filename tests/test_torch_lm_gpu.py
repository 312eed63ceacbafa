"""The LM serve path's CUDA kernels against their plain versions, and the
served models (the SSM, dense, MoE, interleaved MoE, VLM, hybrid and
encoder-decoder families, at their reduced configs) on the card against
the same models on the CPU.

Every test here is marked ``gpu`` and skips where there is no CUDA device.
The file imports neither JAX nor the JAX package:

    python -m pytest -q --noconftest -m gpu tests/test_torch_lm_gpu.py

Tolerances: ssd_intra rtol 2e-4, atol 2e-4 (the reference sweep's: f32
sums in another order, a warp-scan cumsum; the kernel's products are three
TF32 products each, ~2^-21); sw_attention rtol 1e-4, atol 1e-4 in f32 and
bf16 alike (both versions read the same bf16 values; the bf16 instance's
Q K^T products are exact in f32 and its P V splits P into two bf16 parts,
~2^-17 of P); the reduced models' prefill logits, card against CPU, rtol
1e-4, atol 1e-4 (f32 throughout, TF32 off); greedy tokens equal; the MoE
and VLM prefills' logits bit-identical over two runs on the card (the MoE
combine adds in expert order, no atomics); with the perf variants
(``kv_quant`` and ``triangle_prefill``) on the dense, MoE and VLM reduced
configs, the same prefill tolerance, the int8 caches at most one count
apart (the two devices' f32 projections may round a value to the other
side of a half), a decode step on the CPU's cache carried to the card
within rtol 1e-4, atol 1e-4, and the greedy tokens equal.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import _build
from repro_torch.kernels.ssd_scan.kernel import ssd_intra_cuda
from repro_torch.kernels.ssd_scan.ops import ssd_chunked_kernel
from repro_torch.kernels.ssd_scan.ref import ssd_intra_ref
from repro_torch.kernels.sw_attention.kernel import sw_attention_cuda
from repro_torch.kernels.sw_attention.ref import sw_attention_ref
from repro_torch.models import get_model, transformer
from repro_torch.training.serve import Server
from repro_torch.utils.tree import tree_map


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _intra_inputs(dims, device, seed):
    B, nc, Q, H, P, N = dims
    g = torch.Generator(device=device).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=device)
    la = -rnd(B, nc, Q, H).abs() * 0.1
    dt = rnd(B, nc, Q, H).abs()
    return la, dt, rnd(B, nc, Q, H, P), rnd(B, nc, Q, N), rnd(B, nc, Q, N)


@pytest.mark.gpu
@pytest.mark.parametrize("dims", [(1, 2, 128, 3, 64, 128),  # the full Q, P, N
                                  (2, 3, 32, 3, 32, 16),    # reduced configs
                                  (1, 2, 50, 2, 24, 20),    # Q < 128, odd
                                  (2, 1, 8, 1, 4, 8),
                                  (1, 1, 127, 2, 8, 33),
                                  (8, 16, 128, 32, 64, 128),   # served
                                  (1, 2, 128, 3, 128, 128),    # one x buffer
                                  (2, 16, 128, 64, 64, 64)])   # zamba2's
def test_ssd_intra_cuda_matches_plain(cuda, dims):
    ins = _intra_inputs(dims, cuda, seed=sum(dims))
    n0 = _build.LAUNCHES["ssd_intra"]
    y, st = ssd_intra_cuda(*ins)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["ssd_intra"] == n0 + 1
    want_y, want_st = ssd_intra_ref(*ins)
    torch.testing.assert_close(y, want_y, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(st, want_st, rtol=2e-4, atol=2e-4)
    y2, st2 = ssd_intra_cuda(*ins)
    assert torch.equal(y, y2) and torch.equal(st, st2)   # same on every run


@pytest.mark.gpu
def test_ssd_chunked_kernel_on_the_card_matches_the_cpu(cuda):
    g = torch.Generator().manual_seed(3)
    B, S, H, P, N = 2, 96, 3, 16, 16
    x = torch.randn(B, S, H, P, generator=g)
    dt = torch.nn.functional.softplus(torch.randn(B, S, H, generator=g))
    A = -torch.exp(torch.randn(H, generator=g))
    Bm, Cm = torch.randn(B, S, N, generator=g), torch.randn(B, S, N,
                                                            generator=g)
    h0 = torch.randn(B, H, P, N, generator=g)
    args = (x, dt, A, Bm, Cm)
    y_cpu, h_cpu = ssd_chunked_kernel(*args, chunk=32, h0=h0)
    n0 = _build.LAUNCHES["ssd_intra"]
    y, h = ssd_chunked_kernel(*(a.to(cuda) for a in args), chunk=32,
                              h0=h0.to(cuda))
    assert _build.LAUNCHES["ssd_intra"] == n0 + 1
    torch.testing.assert_close(y.cpu(), y_cpu, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(h.cpu(), h_cpu, rtol=2e-4, atol=2e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("BH,G,S,Dh,W", [
    (2, 6, 100, 128, 100),     # causal, S not a multiple of the tile
    (1, 1, 257, 64, 40),       # G = 1, W below S
    (3, 6, 130, 64, 500),      # W above S
    (1, 2, 64, 128, 1),        # each row sees itself only
    (2, 6, 320, 128, 128),     # W below S, several tiles
    (1, 2, 1000, 128, 200),    # band edges off the 64-key tiles
    (1, 1, 1, 128, 1),         # S = 1
    (8, 6, 2048, 128, 2048),   # qwen2-1.5b's causal prefill, served
    (2, 6, 8192, 128, 4096),   # and its ring prefill
    (16, 1, 2048, 64, 2048),   # zamba2-1.2b's shared block, Dh 64, G 1
    (16, 1, 384, 64, 384),     # whisper-medium's decoder, ends mid-tile
    (2, 16, 2048, 128, 2048),  # qwen3-moe's G 16
    (2, 5, 2048, 128, 2048),   # llama4-maverick's G 5
    (2, 8, 3072, 128, 3072)])  # internvl2's G 8, 1,024 patches + 2,048
def test_sw_attention_cuda_matches_plain(cuda, dtype, BH, G, S, Dh, W):
    g = torch.Generator(device=cuda).manual_seed(S + W)
    q = torch.randn((BH, G, S, Dh), generator=g, device=cuda).to(dtype)
    k = torch.randn((BH, S, Dh), generator=g, device=cuda).to(dtype)
    v = torch.randn((BH, S, Dh), generator=g, device=cuda).to(dtype)
    n0 = _build.LAUNCHES["sw_attention"]
    got = sw_attention_cuda(q, k, v, window=W)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["sw_attention"] == n0 + 1
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, sw_attention_ref(q, k, v, window=W),
                               rtol=1e-4, atol=1e-4)
    assert torch.equal(got, sw_attention_cuda(q, k, v, window=W))


@pytest.mark.gpu
def test_unsplit_p_would_break_the_tolerance(cuda):
    """The bf16 instance splits P into two bf16 parts; P rounded once to
    bf16 (the plain softmax, unnormalised, times V) would err past the
    tolerance. Both errors are printed, so the reason stays on record."""
    BH, G, S, Dh = 8, 6, 2048, 128
    g = torch.Generator(device=cuda).manual_seed(S)
    q, k, v = (torch.randn(shape, generator=g, device=cuda).to(torch.bfloat16)
               for shape in ((BH, G, S, Dh), (BH, S, Dh), (BH, S, Dh)))
    want = sw_attention_ref(q, k, v, window=S)
    s = torch.einsum("bgqd,bkd->bgqk", q.float(), k.float()) / Dh ** 0.5
    s = s.masked_fill(torch.ones(S, S, dtype=torch.bool, device=cuda)
                      .triu(1), float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    one = torch.einsum("bgqk,bkd->bgqd", p.to(torch.bfloat16).float(),
                       v.float()) / p.sum(-1, keepdim=True)
    del s, p
    got = sw_attention_cuda(q, k, v, window=S)

    def ratio(x):
        return float(((x - want).abs() / (1e-4 + 1e-4 * want.abs())).max())
    print(f"sw_attention bf16 {BH, G, S, Dh}: P split in two, "
          f"{ratio(got):.3g} of the tolerance; P rounded once to bf16, "
          f"{ratio(one):.3g}")
    assert ratio(got) <= 1.0 < ratio(one)


@pytest.mark.gpu
def test_bf16_instance_refuses_misaligned_inputs(cuda):
    """TMA needs 16-byte aligned rows: the wrapper raises, and neither
    launches nor takes the plain version."""
    buf = torch.zeros(1 + 2 * 64 * 128, device=cuda, dtype=torch.bfloat16)
    q = buf[1:].view(1, 2, 64, 128)                 # 2 bytes off
    k = torch.zeros((1, 64, 128), device=cuda, dtype=torch.bfloat16)
    n0 = _build.LAUNCHES["sw_attention"]
    with pytest.raises(ValueError, match="16-byte aligned"):
        sw_attention_cuda(q, k, k, window=64)
    assert _build.LAUNCHES["sw_attention"] == n0
    got = sw_attention_cuda(q.float(), k.float(), k.float(), window=64)
    assert _build.LAUNCHES["sw_attention"] == n0 + 1   # f32: the SIMT one
    assert torch.equal(got, torch.zeros_like(got))


@pytest.mark.gpu
def test_kernel_wrappers_refuse_what_they_do_not_take(cuda):
    q = torch.zeros((1, 1, 8, 32), device=cuda)
    k = torch.zeros((1, 8, 32), device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        sw_attention_cuda(q, k, k, window=8)
    ins = _intra_inputs((1, 1, 129, 1, 4, 4), cuda, seed=0)
    with pytest.raises(ValueError, match="exceeds"):
        ssd_intra_cuda(*ins)
    ins = _intra_inputs((1, 1, 128, 1, 192, 128), cuda, seed=0)
    with pytest.raises(ValueError, match="shared memory"):
        ssd_intra_cuda(*ins)


def _prefill_launches(cfg) -> dict:
    """Each serve kernel's launches in one prefill of ``cfg``."""
    if cfg.family == "ssm":
        return {"ssd_intra": cfg.n_layers, "sw_attention": 0}
    if cfg.family == "hybrid":
        return {"ssd_intra": cfg.n_layers,
                "sw_attention": -(-cfg.n_layers // cfg.attn_every)}
    return {"ssd_intra": 0, "sw_attention": cfg.n_layers}


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["mamba2-370m", "qwen2-1.5b", "zamba2-1.2b",
                                  "whisper-medium", "qwen3-moe-235b-a22b",
                                  "llama4-maverick-400b-a17b",
                                  "internvl2-76b"])
def test_reduced_model_on_the_card_matches_the_cpu(cuda, name):
    cfg = get_config(name, reduced=True)
    ops = get_model(cfg)
    params = ops.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    rng = np.random.default_rng(1)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab, (2, 64)).astype(np.int32))}
    if cfg.family == "audio":
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (2, cfg.enc_seq, cfg.d_model)).astype(np.float32))
    if cfg.family == "vlm":
        batch["patches"] = torch.from_numpy(rng.standard_normal(
            (2, cfg.n_patches, cfg.vit_dim)).astype(np.float32))
    logits_cpu, _ = ops.prefill(params, batch, cfg)
    gparams = tree_map(lambda x: x.to(cuda), params)
    gbatch = {k: v.to(cuda) for k, v in batch.items()}
    n0 = dict(_build.LAUNCHES)
    logits, _ = ops.prefill(gparams, gbatch, cfg)
    assert {k: _build.LAUNCHES[k] - n0[k] for k in
            ("ssd_intra", "sw_attention")} == _prefill_launches(cfg)
    torch.testing.assert_close(logits.cpu(), logits_cpu, rtol=1e-4, atol=1e-4)
    want = Server(cfg, params, device="cpu").generate(batch, 6)
    got = Server(cfg, gparams, device=cuda).generate(batch, 6)
    assert torch.equal(got.cpu(), want)
    if cfg.family in ("moe", "vlm"):
        again, _ = ops.prefill(gparams, gbatch, cfg)
        assert torch.equal(again, logits)   # the same bits on every run


@pytest.mark.gpu
def test_ring_prefill_on_the_card_matches_the_cpu(cuda):
    cfg = get_config("qwen2-1.5b", reduced=True)
    params = get_model(cfg).init_params(torch.Generator().manual_seed(0),
                                        cfg, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (1, 97)).astype(np.int32))
    spec = transformer.cache_spec(cfg, 96, use_window=True)
    assert spec.ring
    out = {}
    for dev in ("cpu", cuda):
        p = tree_map(lambda x: x.to(dev), params)
        logits, cache = transformer.prefill(
            p, {"tokens": toks[:, :96].to(dev)}, cfg, spec)
        logits2, _ = get_model(cfg).decode_step(p, cache,
                                                toks[:, 96:].to(dev), cfg)
        out[str(dev)] = (logits.cpu(), logits2.cpu(), cache["k"].cpu())
    for a, b in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["yi-9b", "granite-8b", "command-r-plus-104b",
                                  "qwen3-moe-235b-a22b",
                                  "llama4-maverick-400b-a17b",
                                  "internvl2-76b"])
def test_perf_variants_on_the_card_match_the_cpu(cuda, name):
    cfg = dataclasses.replace(get_config(name, reduced=True), kv_quant=True,
                              triangle_prefill=True)
    ops = get_model(cfg)
    params = ops.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    rng = np.random.default_rng(3)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab, (2, 64)).astype(np.int32))}
    if cfg.family == "vlm":
        batch["patches"] = torch.from_numpy(rng.standard_normal(
            (2, cfg.n_patches, cfg.vit_dim)).astype(np.float32))
    gparams = tree_map(lambda x: x.to(cuda), params)
    gbatch = {k: v.to(cuda) for k, v in batch.items()}
    logits_cpu, cache_cpu = ops.prefill(params, batch, cfg)
    n0 = dict(_build.LAUNCHES)
    logits, cache = ops.prefill(gparams, gbatch, cfg)
    assert _build.LAUNCHES["sw_attention"] - n0["sw_attention"] \
        == cfg.n_layers
    torch.testing.assert_close(logits.cpu(), logits_cpu, rtol=1e-4, atol=1e-4)
    assert cache["k"].dtype == torch.int8 and cache["k"].is_cuda
    for key in ("k", "v"):
        assert int((cache[key].cpu().int() - cache_cpu[key].int()).abs()
                   .max()) <= 1
        torch.testing.assert_close(cache[key + "_scale"].cpu(),
                                   cache_cpu[key + "_scale"], rtol=1e-5,
                                   atol=0)
    tok = torch.argmax(logits_cpu[:, -1], dim=-1)[:, None].to(torch.int32)
    carried = tree_map(lambda x: x.to(cuda), cache_cpu)
    got = ops.decode_step(gparams, carried, tok.to(cuda), cfg)[0]
    want = ops.decode_step(params, cache_cpu, tok, cfg)[0]
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    toks_cpu = Server(cfg, params, device="cpu").generate(batch, 6)
    toks = Server(cfg, gparams, device=cuda).generate(gbatch, 6)
    assert torch.equal(toks.cpu(), toks_cpu)
