"""The arithmetic of the tensor-core designs of sw_attention and ssd_intra,
emulated on the CPU and held to the kernels' plain versions.

The CUDA kernels run only on the card; these emulations repeat their
schedules and roundings in torch, so a fault of schedule, masking or
precision shows before any card time:

- sw_attention's bf16 instance (``csrc/sw_attention.cu``): 128-row query
  tiles, two 64-row warpgroups, the 64-key tiles of the band from
  ``_kv_start_block``'s tile to the diagonal (keys past S read as zeros),
  masks only on tiles that cross the diagonal, the band's lower edge or
  the end of the keys, the online softmax in base 2 with one rescale per
  tile, and P V as two products of P's bf16 high and low parts.
- ssd_intra (``csrc/ssd_intra.cu``): G = C B^T once for all heads, every
  product as three TF32 products (hi rounded to nearest, lo = a - hi read
  as TF32 by truncation) summed in f32 per 8-wide k step, M built from G.

Tolerances are those of the GPU tests (``tests/test_torch_lm_gpu.py``:
assert_close rtol = atol = 1e-4 for sw_attention, 2e-4 for ssd_intra) and
of ``chip_smoke.py`` (|got - want| <= 1e-4 |want| + 1e-4 max|want|). Two
cases show why the products are split: P rounded once to bf16, and a
bf16x3 split of ssd_intra's products, each exceed them.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.ssd_scan.kernel import (SMEM_LIMIT,
                                                 ssd_intra_smem_bytes)
from repro_torch.kernels.ssd_scan.ref import ssd_intra_ref
from repro_torch.kernels.sw_attention.ref import sw_attention_ref

NEG = -1e30
LOG2E = 1.4426950408889634


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while these tests run: the suite runs several
    workers on a few cores, and torch's default of one thread per core in
    each of them oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close_ratio(got, want, rtol, atol):
    """max |got - want| / (atol + rtol |want|): assert_close's form."""
    return float(((got - want).abs() / (atol + rtol * want.abs())).max())


def _smoke_ratio(got, want):
    """chip_smoke.py's form: max |d| / (1e-4 |want| + 1e-4 max|want|)."""
    lim = 1e-4 * (want.abs() + want.abs().max())
    return float(((got - want).abs() / lim).max())


def _mm(a, b):
    """a @ b of f32 operands as the tensor cores sum them: exact products
    (bf16 and TF32 products fit f32), one f32 rounding of the result."""
    return (a.double() @ b.double()).float()


# ---------------------------------------------------------------------------
# sw_attention, bf16 instance
# ---------------------------------------------------------------------------

def _visible(rows, keys, window, S):
    q, k = rows[:, None], keys[None, :]
    return (k < S) & (k <= q) & (q - k < window)


def sw_attention_emulated(q, k, v, *, window, split=True):
    """q: (BH, G, S, Dh), k, v: (BH, S, Dh) bf16 -> (BH, G, S, Dh) f32, by
    the kernel's schedule."""
    BH, G, S, Dh = q.shape
    window = min(window, S)
    scale2 = torch.tensor((1.0 / math.sqrt(Dh)) * LOG2E, dtype=torch.float32)
    qf, kf, vf = q.float(), k.float(), v.float()
    out = torch.zeros((BH, G, S, Dh), dtype=torch.float32)
    pad = torch.zeros((BH, 64, Dh))
    kf, vf = torch.cat([kf, pad], 1), torch.cat([vf, pad], 1)
    for q0 in range(0, S, 128):
        k_begin = max(0, (q0 - window) // 64) * 64
        n_tiles = -(-(min(S, q0 + 128) - k_begin) // 64)
        for r0 in range(q0, min(q0 + 128, S), 64):           # warpgroups
            r_last = min(r0 + 63, S - 1)
            rows = torch.arange(r0, r_last + 1)
            t_hi = min(n_tiles, (r_last - k_begin) // 64 + 1)
            below = r0 - window + 1 - 63 - k_begin
            t_lo = 0 if below <= 0 else -(-below // 64)
            n = len(rows)
            m = torch.full((BH, G, n), NEG)
            lsum = torch.zeros((BH, G, n))
            o = torch.zeros((BH, G, n, Dh))
            for t in range(t_lo, t_hi):
                kt = k_begin + 64 * t
                keys = torch.arange(kt, kt + 64)
                kk, vv = kf[:, kt:kt + 64], vf[:, kt:kt + 64]
                s = _mm(qf[:, :, r0:r_last + 1], kk[:, None].transpose(-1, -2))
                s = s * scale2
                if kt + 63 > r0 or r_last - kt >= window or kt + 63 >= S:
                    s = torch.where(_visible(rows, keys, window, S), s,
                                    torch.tensor(NEG))
                mn = torch.maximum(m, s.amax(-1))
                c = torch.exp2(m - mn)
                p = torch.where(s == NEG, torch.zeros(()),
                                torch.exp2(s - mn[..., None]))
                lsum = lsum * c + p.sum(-1)
                o = o * c[..., None]
                hi = p.to(torch.bfloat16).float()
                if split:
                    lo = (p - hi).to(torch.bfloat16).float()
                    o = o + _mm(hi, vv[:, None]) + _mm(lo, vv[:, None])
                else:
                    o = o + _mm(hi, vv[:, None])
                m = mn
            out[:, :, r0:r_last + 1] = o / lsum.clamp_min(1e-30)[..., None]
    return out


def _sw_inputs(BH, G, S, Dh, seed):
    rng = np.random.default_rng(seed)

    def rnd(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
            torch.bfloat16)
    return rnd(BH, G, S, Dh), rnd(BH, S, Dh), rnd(BH, S, Dh)


@pytest.mark.parametrize("BH,G,S,Dh,W", [
    (2, 6, 100, 128, 100),     # the GPU tests' shapes: causal, ragged S
    (1, 1, 257, 64, 40),       # G = 1, W below S
    (3, 6, 130, 64, 500),      # W above S
    (1, 2, 64, 128, 1),        # each row sees itself only
    (2, 6, 320, 128, 128),     # W below S, several tiles
    (1, 2, 1000, 128, 200),    # band edges off the tiles
    (1, 1, 1, 128, 1),         # S = 1
    (1, 6, 2048, 128, 2048)])  # one bh of qwen2-1.5b's causal prefill
def test_sw_attention_schedule_matches_plain(BH, G, S, Dh, W):
    q, k, v = _sw_inputs(BH, G, S, Dh, seed=S + W)
    got = sw_attention_emulated(q, k, v, window=W)
    want = sw_attention_ref(q, k, v, window=W)
    assert _close_ratio(got, want, 1e-4, 1e-4) <= 1.0
    assert _smoke_ratio(got, want) <= 1.0


def test_unsplit_p_exceeds_the_tolerance():
    """P rounded once to bf16 errs by up to 2^-9 of itself: over the tile
    schedule it breaks both tolerances; split in two it holds them."""
    q, k, v = _sw_inputs(1, 6, 2048, 128, seed=7)
    want = sw_attention_ref(q, k, v, window=2048)
    one = sw_attention_emulated(q, k, v, window=2048, split=False)
    assert _close_ratio(one, want, 1e-4, 1e-4) > 1.0
    assert _smoke_ratio(one, want) > 1.0
    two = sw_attention_emulated(q, k, v, window=2048)
    assert _close_ratio(two, want, 1e-4, 1e-4) <= 1.0


# ---------------------------------------------------------------------------
# ssd_intra
# ---------------------------------------------------------------------------

def _tf32_split(a):
    """(hi, lo): hi = a rounded to TF32 (to nearest, ties away), lo = a -
    hi as the tensor core reads it (truncated to TF32)."""
    hi = ((a.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)
    lo = ((a - hi).view(torch.int32) & -0x2000).view(torch.float32)
    return hi, lo


def _bf16_split(a):
    hi = a.to(torch.bfloat16).float()
    return hi, (a - hi).to(torch.bfloat16).float()


def _mm3(a, b, split):
    """a @ b (f32) as three products of split parts, lo hi + hi lo + hi hi,
    accumulated in f32 over 8-wide k steps (one mma.sync m16n8k8 each)."""
    ah, al = split(a)
    bh, bl = split(b)
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:])
    for k0 in range(0, a.shape[-1], 8):
        ks = slice(k0, k0 + 8)
        for x, y in ((al, bh), (ah, bl), (ah, bh)):
            acc = (acc.double() + x[..., ks].double() @ y[..., ks, :].double()
                   ).float()
    return acc


def ssd_intra_emulated(la, dt, x, Bm, Cm, split=_tf32_split):
    """Same contract as ssd_intra_ref, by the kernel's arithmetic: per
    (batch, chunk) G = C B^T once, then per head M = G exp(cum_i - cum_j)
    dt_j on the causal half, y = M x and state = B^T (x w)."""
    B, nc, Q, H = la.shape
    cum = torch.cumsum(la, dim=2)
    G = _mm3(Cm, Bm.transpose(-1, -2), split)                  # (B,nc,Q,Q)
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool))
    y = torch.zeros(x.shape)
    state = torch.zeros((B, nc, H, Bm.shape[-1], x.shape[-1]))
    for h in range(H):
        c, d = cum[..., h], dt[..., h]
        decay = torch.where(causal, c[..., :, None] - c[..., None, :],
                            torch.zeros(()))
        M = torch.where(causal, G * torch.exp(decay) * d[..., None, :],
                        torch.zeros(()))
        y[..., h, :] = _mm3(M, x[..., h, :], split)
        w = torch.exp(c[..., -1:] - c) * d
        state[:, :, h] = _mm3(Bm.transpose(-1, -2),
                              x[..., h, :] * w[..., None], split)
    return y, state


def _ssd_inputs(dims, seed):
    B, nc, Q, H, P, N = dims
    rng = np.random.default_rng(seed)

    def rnd(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32))
    la = -rnd(B, nc, Q, H).abs() * 0.1
    dt = rnd(B, nc, Q, H).abs()
    return la, dt, rnd(B, nc, Q, H, P), rnd(B, nc, Q, N), rnd(B, nc, Q, N)


@pytest.mark.parametrize("dims", [(1, 2, 128, 3, 64, 128),   # the GPU tests'
                                  (2, 3, 32, 3, 32, 16),
                                  (1, 2, 50, 2, 24, 20),
                                  (2, 1, 8, 1, 4, 8),
                                  (1, 1, 127, 2, 8, 33),
                                  (1, 1, 128, 32, 64, 128),   # mamba2-370m
                                  (1, 2, 128, 3, 128, 128)])  # one x buffer
def test_ssd_intra_arithmetic_matches_plain(dims):
    ins = _ssd_inputs(dims, seed=sum(dims))
    got = ssd_intra_emulated(*ins)
    want = ssd_intra_ref(*ins)
    for g, w in zip(got, want):
        assert _close_ratio(g, w, 2e-4, 2e-4) <= 1.0
        assert _smoke_ratio(g, w) <= 1.0


def test_bf16x3_split_exceeds_the_tolerance():
    """Split into bf16 parts (~2^-16 a product) ssd_intra's y breaks the
    GPU tests' 2e-4 where its sums of ~10-sized terms cancel; TF32 parts
    (~2^-21) hold it: the reason the kernel runs 3xTF32."""
    ins = _ssd_inputs((1, 2, 128, 3, 64, 128), seed=5)
    want_y = ssd_intra_ref(*ins)[0]
    bf16_y = ssd_intra_emulated(*ins, split=_bf16_split)[0]
    assert _close_ratio(bf16_y, want_y, 2e-4, 2e-4) > 1.0
    tf32_y = ssd_intra_emulated(*ins)[0]
    assert _close_ratio(tf32_y, want_y, 2e-4, 2e-4) <= 1.0


@pytest.mark.parametrize("Q,N,P,fits", [(128, 128, 64, True),
                                        (128, 128, 128, True),
                                        (128, 128, 129, False),
                                        (127, 33, 8, True),
                                        (50, 20, 24, True)])
def test_ssd_intra_shared_memory_sizing(Q, N, P, fits):
    """The wrapper's mirror of the kernel's shared-memory layout: two x
    buffers at the served P = 64, one at P = 128, and a refusal beyond."""
    smem = ssd_intra_smem_bytes(Q, N, P)
    assert (smem <= SMEM_LIMIT) == fits
    Qp, Pp = -(-Q // 16) * 16, -(-P // 64) * 64
    one_x = 4 * Qp * (-(-Pp // 32) * 32 + 8)
    if (Q, N, P) == (128, 128, 128):
        assert smem + one_x > SMEM_LIMIT      # two x buffers would not fit
