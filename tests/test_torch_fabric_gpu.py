"""The fabric's CUDA kernels against their plain versions, on the card.

Every test here is marked ``gpu`` and skips where there is no CUDA device.
The file imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch and the CUDA toolkit:

    python -m pytest -q --noconftest -m gpu tests/test_torch_fabric_gpu.py

- arena_maintain: parity and replica bit for bit, scores within rtol 1e-4
  (f32 sums in another order) and bit-identical from run to run, on
  layouts with multi-tile blocks, a tail region, colocated leaves and
  every dtype code the arena has (raw random bits, so subnormals, NaNs and
  infinities are decoded too);
- arena_scatter and parity_xor (encode and reconstruct): bit for bit;
  parity_xor also on seeded random plans (ragged rows at unaligned
  offsets, partial overlaps, zero-term rows, a piece of more than 32
  terms) with pointers 0 to 3 words past a 16-byte boundary, and pieces
  in tiles of 13 words whose batches of terms switch between the 16- and
  4-byte paths;
- the controller's PARITY-tier recovery on the card equals the CPU's.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import arena as ta
from repro_torch.core.blocks import WORD_DTYPE_NAMES, partition_pytree
from repro_torch.core.controller import FTController
from repro_torch.core.policy import CheckpointPolicy, SelectionStrategy
from repro_torch.fabric import FabricConfig
from repro_torch.fabric.domains import FailureDomainMap
from repro_torch.fabric.parity import ParityCodec
from repro_torch.fabric.placement import ClusterView
from repro_torch.kernels import _build
from repro_torch.kernels.fused_maintain import ops
from repro_torch.kernels.fused_maintain.kernel import (arena_maintain_cuda,
                                                       arena_scatter_cuda)
from repro_torch.kernels.fused_maintain.ref import (arena_maintain_ref,
                                                    arena_scatter_ref)
from repro_torch.kernels.parity_xor.kernel import parity_xor_cuda
from repro_torch.kernels.parity_xor.ops import (_plan, encode_plan,
                                                reconstruct_plan)
from repro_torch.kernels.parity_xor.ref import parity_xor_ref
from repro_torch.sharding.partition import block_device_homes
from repro_torch.utils.tree import tree_map

_BITS = {1: torch.int8, 2: torch.int16, 4: torch.int32}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _random_leaf(gen, shape, dtype):
    bits = torch.randint(-2**31, 2**31 - 1, (int(np.prod(shape) or 1),),
                         generator=gen, dtype=torch.int64)
    raw = bits.to(torch.int32).view(torch.int8)[:int(np.prod(shape) or 1)
                                                * dtype.itemsize]
    return raw.view(_BITS[dtype.itemsize]).view(dtype).reshape(shape)


def _tree(kind, seed=0):
    gen = torch.Generator().manual_seed(seed)
    if kind == "codes":
        dts = [getattr(torch, n) for n in WORD_DTYPE_NAMES
               if hasattr(torch, n)]
        tree = {f"m{i:02d}": _random_leaf(gen, (20 + i, 70), d)
                for i, d in enumerate(dts)}
        tree.update({f"t{i:02d}": _random_leaf(gen, (3 + i,), d)
                     for i, d in enumerate(dts)})
        return tree, ()
    if kind == "colocate":
        net = {"a": torch.randn(40, 40, generator=gen),
               "b": torch.randn(7, generator=gen)}
        return {"net": net, "mu": tree_map(lambda x: x * 0.5, net)}, \
            ("net", "mu")
    return {"big": torch.randn(40, 300, generator=gen),
            "w": torch.randn(50, 6, generator=gen),
            "b": torch.randn(5, generator=gen),
            "s": torch.randn((), generator=gen)}, ()


def _setup(kind, device, block_rows=8):
    tree, col = _tree(kind)
    part = partition_pytree(tree, block_rows, colocate=col)
    lay = ta.build_arena_layout(part)
    codec = ParityCodec(part, ClusterView(FailureDomainMap(8, 2, 2),
                                          block_device_homes(part, 8)),
                        group_size=3, arena_layout=lay)
    x = ta.pack_arena(tree, lay).to(device)
    z = ta.pack_arena(_tree(kind, seed=1)[0], lay).to(device)
    return part, lay, codec, x, z


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["f32", "codes", "colocate"])
def test_arena_maintain_cuda_matches_plain(cuda, kind):
    part, lay, codec, x, z = _setup(kind, cuda)
    plan = ops.sweep_plan(lay, codec.layout, codec.group_of)
    t = plan.on(cuda)
    shape = codec.n_groups * codec.layout.frame_elems
    par_k = torch.full((shape,), 7, dtype=torch.int32, device=cuda)
    par_p = torch.zeros((shape,), dtype=torch.int32, device=cuda)
    rep_k, rep_p = torch.zeros_like(x), torch.zeros_like(x)
    n0 = _build.LAUNCHES["arena_maintain"]
    got = arena_maintain_cuda(x, z, t, par_k, rep_k)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["arena_maintain"] == n0 + 1
    want = arena_maintain_ref(x, z, t, par_p, rep_p)
    # the kernel writes every tile a destination owns; the rest is padding
    owned = torch.zeros((shape // 1024,), dtype=torch.bool, device=cuda)
    owned[t["dest_tile"].long()] = True
    assert torch.equal(par_k.view(-1, 1024)[owned],
                       par_p.view(-1, 1024)[owned])
    assert torch.equal(rep_k[:lay.tail_start], x[:lay.tail_start])
    torch.testing.assert_close(got, want, rtol=1e-4, atol=0, equal_nan=True)
    again = arena_maintain_cuda(x, z, t, par_k, None)
    assert torch.equal(again.nan_to_num(0.0), got.nan_to_num(0.0))
    # the score-only plan (arena_drift_scores) agrees as well
    torch.testing.assert_close(ta.arena_drift_scores(x, z, lay), want,
                               rtol=1e-4, atol=0, equal_nan=True)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["f32", "codes", "colocate"])
def test_arena_scatter_cuda_matches_plain(cuda, kind):
    part, lay, codec, x, z = _setup(kind, cuda)
    rng = np.random.default_rng(2)
    ids = rng.choice(part.total_blocks, size=max(1, part.total_blocks // 3),
                     replace=False)
    t = ops.scatter_plan(*ops.save_ranges(lay, ids), cuda)
    got = arena_scatter_cuda(z.clone(), x, t)
    want = arena_scatter_ref(z.clone(), x, t)
    assert torch.equal(got, want)
    out, moved = ops.arena_scatter_save(z.clone(), x, lay, ids)
    assert torch.equal(out, want) and moved == lay.seg_bytes_for_blocks(ids)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["f32", "codes", "colocate"])
def test_parity_xor_cuda_matches_plain(cuda, kind):
    part, lay, codec, x, z = _setup(kind, cuda)
    fe = codec.layout.frame_elems
    enc = encode_plan(lay, codec.layout, codec.members)
    n = codec.n_groups * fe
    got = parity_xor_cuda(torch.full((n,), 5, dtype=torch.int32,
                                     device=cuda), x, None,
                          enc.pieces_on(cuda))
    want = parity_xor_ref(torch.zeros((n,), dtype=torch.int32, device=cuda),
                          x, None, enc.on(cuda))
    assert torch.equal(got, want)
    # the sweep's parity is the same function of the arena
    par = torch.zeros((n,), dtype=torch.int32, device=cuda)
    arena_maintain_cuda(x, None, ops.sweep_plan(
        lay, codec.layout, codec.group_of).on(cuda), par, None)
    assert torch.equal(par, got)
    lost = np.zeros((part.total_blocks,), bool)
    for j, row in enumerate(codec.members):
        lost[row[row >= 0][j % int((row >= 0).sum())]] = True
    keep = codec.valid & ~lost[np.where(codec.valid, codec.members, 0)]
    plan, blocks = reconstruct_plan(lay, codec.layout, codec.group_of,
                                    codec.members, np.nonzero(lost)[0], keep)
    rec_k = parity_xor_cuda(torch.empty((plan.out_words,), dtype=torch.int32,
                                        device=cuda), x, got,
                            plan.pieces_on(cuda))
    rec_p = parity_xor_ref(torch.empty((plan.out_words,), dtype=torch.int32,
                                       device=cuda), x, got, plan.on(cuda))
    assert torch.equal(rec_k, rec_p)
    ab = lay.ab_arrays()
    off = 0
    for a in blocks:                     # the lost blocks' own words
        n_a = int(ab["payload"][a])
        o = int(ab["offset"][a])
        assert torch.equal(rec_k[off:off + n_a], x[o:o + n_a])
        off += n_a


def _at(x, device, shift):
    """``x`` on ``device`` as a view ``shift`` words into a larger buffer
    (a pointer 4 * shift bytes past a 16-byte boundary)."""
    buf = torch.zeros((x.numel() + 4,), dtype=torch.int32, device=device)
    buf[shift:shift + x.numel()] = x.to(device)
    return buf[shift:shift + x.numel()]


@pytest.mark.gpu
@pytest.mark.parametrize("shifts", [(0, 0, 0), (1, 1, 1), (2, 0, 2),
                                    (3, 1, 0)])
def test_parity_xor_random_plans_match_plain(cuda, shifts):
    rng = np.random.default_rng(7)
    rows, terms, out = [], [], 1
    for r in range(60):
        n = int(rng.integers(1, 70))
        rows.append((out, n, -1 if r % 2 else int(rng.integers(0, 300))))
        out += n
        k = 0 if r % 9 == 4 else (40 if r == 6 else int(rng.integers(1, 5)))
        ts = []
        for _ in range(k):
            a = 0 if r == 6 else int(rng.integers(0, n))
            ln = n if r == 6 else int(rng.integers(1, n - a + 1))
            ts.append((a, int(rng.integers(0, 2000 - ln)), ln))
        terms.append(ts)
    plan = _plan(rows, terms)
    words = lambda n: torch.from_numpy(  # noqa: E731
        rng.integers(-2**31, 2**31, n).astype(np.int32))
    src, base, init = words(2000), words(400), words(plan.out_words)
    want = parity_xor_ref(init.clone(), src, base, plan.on("cpu"))
    got = _at(init, cuda, shifts[0])
    parity_xor_cuda(got, _at(src, cuda, shifts[1]), _at(base, cuda, shifts[2]),
                    plan.pieces_on(cuda))
    assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
def test_parity_xor_small_tiles_and_mixed_width_batches(cuda):
    """Rows of 33 to 45 terms over one piece, cut into tiles of 13 words:
    in rows 0 and 2 the first batch of 32 terms reads sources congruent to
    the output modulo 16 bytes (the 16-byte path) and the rest do not (the
    4-byte path); row 1 the other way round."""
    from repro_torch.kernels.parity_xor.ops import build_pieces
    rng = np.random.default_rng(11)
    rows, terms, out = [], [], 0
    for r, (n, k) in enumerate([(200, 40), (203, 45), (150, 33)]):
        rows.append((out, n, -1 if r == 1 else out))
        terms.append([(0, 4 * int(rng.integers(0, 100)) + (
            0 if (i < 32) != (r == 1) else int(rng.integers(1, 4))), n)
            for i in range(k)])
        out += 4 * (-(-n // 4))
    plan = _plan(rows, terms)
    plan._pieces = build_pieces(plan, 13)
    pc = plan.pieces()
    assert pc.length.size == 3 and (np.diff(pc.term_ptr) > 32).all()
    assert (np.diff(pc.piece_tile) >= 12).all()
    words = lambda n: torch.from_numpy(  # noqa: E731
        rng.integers(-2**31, 2**31, n).astype(np.int32))
    src, base, init = words(700), words(out), words(out)
    want = parity_xor_ref(init.clone(), src, base, plan.on("cpu"))
    for shifts in ((0, 0, 0), (2, 2, 2), (1, 0, 1)):
        got = _at(init, cuda, shifts[0])
        n0 = _build.LAUNCHES["parity_xor"]
        parity_xor_cuda(got, _at(src, cuda, shifts[1]),
                        _at(base, cuda, shifts[2]), plan.pieces_on(cuda))
        torch.cuda.synchronize()
        assert _build.LAUNCHES["parity_xor"] == n0 + 1
        assert torch.equal(got.cpu(), want), shifts


@pytest.mark.gpu
def test_controller_parity_recovery_card_equals_cpu(cuda):
    def run(device):
        tree, _ = _tree("f32")
        tree = tree_map(lambda v: v.to(device), tree)
        pol = CheckpointPolicy(fraction=0.125, full_interval=1, block_rows=8,
                               strategy=SelectionStrategy.PRIORITY)
        ctl = FTController(tree, pol, fabric=FabricConfig(), device=device)
        gen = torch.Generator().manual_seed(4)
        for step in range(1, 4):
            tree = tree_map(lambda v: v + 1e-2 * torch.randn(
                v.shape, generator=gen).to(device), tree)
            ctl.maintain(step, tree)
            ctl.maybe_checkpoint(step, tree)
        fab = ctl.fabric
        failed = np.unique([fab.view.homes[0], fab.replicas.replica_homes[0]])
        lost = np.isin(fab.view.homes, failed)
        rec, info = ctl.on_failure(tree, lost, failed_devices=failed, step=3)
        return tree_map(lambda v: v.cpu(), rec), info
    rec_c, info_c = run(cuda)
    rec_h, info_h = run("cpu")
    assert info_c["tier_counts"] == info_h["tier_counts"]
    assert info_c["tier_counts"]["PARITY"] > 0
    assert info_c["tier_sq"]["PARITY"] == 0.0
    for k in rec_c:
        assert torch.equal(rec_c[k], rec_h[k]), k
