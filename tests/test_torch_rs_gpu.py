"""The RS tier's and the per-leaf fabric's CUDA kernels against their plain
versions, on the card.

Every test here is marked ``gpu`` and skips where there is no CUDA device.
The file imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch and the CUDA toolkit:

    python -m pytest -q --noconftest -m gpu tests/test_torch_rs_gpu.py

- gf256_mac: bit for bit on the dense form (ragged E, a one-member group,
  coefficients 0, 1 and random, m = 1 to 4 rows in one launch), on the
  codec's plans (encode, syndromes in batches, a two-source decode), on
  seeded random plans (unaligned offsets and pointers, partial overlaps,
  zero-term rows, a piece of more than 32 terms, src and src2 terms, m = 1
  to 8, row ranges with out_shift), pieces in tiles of 13 words whose
  batches of terms switch between the 16- and 4-byte paths, the codec's
  syndromes in several batches, and every coefficient times every byte
  value;
- fused_maintain: replica and parity bit for bit, scores within rtol 1e-4
  (f32 sums in another order) and bit-identical from run to run, on f32
  leaves with a ragged last block and a single-block tail, colocated
  leaves, the sub-word dtypes, and bool, f64, int64 and complex leaves
  (stored as f32 images);
- an RS(k, 2) two-host loss and the per-leaf fabric's PARITY recovery on
  the card equal the CPU's.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import arena as ta
from repro_torch.core.blocks import partition_pytree
from repro_torch.core.controller import FTController
from repro_torch.core.policy import CheckpointPolicy, SelectionStrategy
from repro_torch.fabric import CheckpointFabric, FabricConfig
from repro_torch.fabric.domains import FailureDomainMap
from repro_torch.fabric.parity import ParityCodec
from repro_torch.fabric.placement import ClusterView
from repro_torch.fabric.rs import RSCodec
from repro_torch.kernels import _build
from repro_torch.kernels.fused_maintain import ops as fops
from repro_torch.kernels.fused_maintain.kernel import fused_maintain_cuda
from repro_torch.kernels.fused_maintain.ref import fused_maintain_ref
from repro_torch.kernels.gf256_mac import ops as gops
from repro_torch.kernels.gf256_mac.kernel import gf256_mac_cuda
from repro_torch.kernels.gf256_mac.ref import (gf256_mac_plan_ref,
                                               gf256_mac_ref)
from repro_torch.kernels.gf256_mac.tables import (gf_scale_words_np,
                                                  rs_coefficients)
from repro_torch.sharding.partition import block_device_homes
from repro_torch.utils.tree import tree_leaves, tree_map


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _words(rng, shape):
    return torch.from_numpy(rng.integers(-2**31, 2**31, shape)
                            .astype(np.int32))


DENSE = [(5, 4, 70, 1), (3, 1, 4097, 2), (7, 3, 1, 3), (2, 6, 9000, 4)]


@pytest.mark.gpu
@pytest.mark.parametrize("n,g,e,m", DENSE)
def test_gf256_mac_dense_matches_plain(cuda, n, g, e, m):
    rng = np.random.default_rng(n * 1000 + e)
    frames, base = _words(rng, (n, g, e)), _words(rng, (n, e))
    coeff = torch.from_numpy(rng.integers(0, 256, (n, g)).astype(np.int32))
    coeff[0, 0] = 0
    coeff[-1, -1] = 1
    n0 = _build.LAUNCHES["gf256_mac"]
    got = gops.gf256_mac(frames.to(cuda), base.to(cuda), coeff)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["gf256_mac"] == n0 + 1
    assert torch.equal(got.cpu(), gf256_mac_ref(frames, base, coeff))
    rows = torch.from_numpy(rng.integers(0, 256, (m, n, g)).astype(np.int32))
    rows[:, 0, 0] = torch.tensor([0, 1, 2, 255][:m], dtype=torch.int32)
    got = gops.rs_encode(frames.to(cuda), rows)
    assert torch.equal(got.cpu(), gops.rs_encode(frames, rows))


def random_gf_plan(rng, m, n_rows=40, src_words=3000, src2_words=700):
    """Rows of ragged lengths at unaligned offsets, some based, some
    without terms; terms at unaligned columns and source offsets that
    overlap in part, from both sources, one row with more than 32 terms
    over one piece; coefficients 0, 1 and random."""
    rows, terms, out = [], [], int(rng.integers(0, 4))
    for r in range(n_rows):
        n = int(rng.integers(1, 90))
        rows.append((out, n, -1 if r % 4 == 1 else int(rng.integers(0, 200))))
        out += n + int(rng.integers(0, 3))
        k = 0 if r % 7 == 3 else (37 if r == 5 else int(rng.integers(1, 7)))
        ts = []
        for _ in range(k):
            a = 0 if r == 5 else int(rng.integers(0, n))
            ln = n if r == 5 else int(rng.integers(1, n - a + 1))
            s2 = int(rng.integers(0, 4) == 0)
            lim = (src2_words if s2 else src_words) - ln
            c = rng.integers(0, 256, m)
            c[rng.random(m) < 0.2] = 1
            c[rng.random(m) < 0.1] = 0
            ts.append((a, int(rng.integers(0, lim)), ln, s2, c))
        terms.append(ts)
    # a row's outputs lie apart from every other row's (unaligned strides)
    ostr = out + int(rng.integers(0, 4)) if m > 1 else 0
    bstr = 1000 + int(rng.integers(0, 3)) if m > 1 else 0
    return gops._plan(m, ostr, bstr, rows, terms), \
        out + (m - 1) * ostr + 100


def _at(x, device, shift):
    """``x`` on ``device`` as a view ``shift`` words into a larger buffer
    (a pointer 4 * shift bytes past a 16-byte boundary)."""
    buf = torch.zeros((x.numel() + 4,), dtype=torch.int32, device=device)
    buf[shift:shift + x.numel()] = x.to(device)
    return buf[shift:shift + x.numel()]


@pytest.mark.gpu
@pytest.mark.parametrize("m", range(1, 9))
def test_gf256_mac_random_plans_match_plain(cuda, m):
    rng = np.random.default_rng(100 + m)
    plan, n_out = random_gf_plan(rng, m)
    assert set(plan.term_sel.tolist()) == {0, 1}
    src, src2 = _words(rng, (3000,)), _words(rng, (700,))
    base = _words(rng, (200 + 7 * 400 * 4 + 90,))
    init = _words(rng, (n_out,))
    want = gf256_mac_plan_ref(init.clone(), src, src2, base, plan.on("cpu"),
                              0, plan.n_rows, 0)
    for shifts in ((0, 0, 0, 0), (1, 1, 1, 1), (3, 0, 2, 1)):
        out = _at(init, cuda, shifts[0])
        gf256_mac_cuda(out, _at(src, cuda, shifts[1]),
                       _at(src2, cuda, shifts[2]),
                       _at(base, cuda, shifts[3]), plan)
        assert torch.equal(out.cpu(), want), shifts
    # a row range with out_shift, as the syndrome batches run it
    shift = int(plan.row_out[10])
    n = plan.limits(10, 20)["out_hi"] - shift
    got = gf256_mac_cuda(torch.zeros((n,), dtype=torch.int32, device=cuda),
                         src.to(cuda), src2.to(cuda), base.to(cuda), plan,
                         10, 20, shift)
    want = gf256_mac_plan_ref(torch.zeros((n,), dtype=torch.int32), src,
                              src2, base, plan.on("cpu"), 10, 20, shift)
    assert torch.equal(got.cpu(), want)


def mixed_width_gf_plan(rng, m):
    """Three rows of 33 to 45 terms that each cover the whole row (one
    piece), at output offsets and strides that are multiples of 4 words,
    based at the same offsets: in rows 0 and 2 the first batch of 32 terms
    reads sources congruent to the output modulo 4 words and the rest do
    not; row 1 the other way round. Returns the plan and the buffers' words
    (out, src, src2, base)."""
    rows, terms, out = [], [], 0
    for r, (n, k) in enumerate([(200, 40), (203, 45), (150, 33)]):
        rows.append((out, n, -1 if r == 1 else out))
        ts = []
        for i in range(k):
            congruent = (i < 32) != (r == 1)
            s2 = int(i % 3 == 2)
            off = 4 * int(rng.integers(0, 100)) + out % 4 \
                + (0 if congruent else int(rng.integers(1, 4)))
            c = rng.integers(0, 256, m)
            c[rng.random(m) < 0.2] = 1
            ts.append((0, off, n, s2, c))
        terms.append(ts)
        out += 4 * (-(-n // 4))
    ostr = out if m > 1 else 0
    return gops._plan(m, ostr, ostr, rows, terms), \
        (out + (m - 1) * ostr, 700, 700, out + (m - 1) * ostr)


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 3, 8])
def test_gf256_mac_small_tiles_and_mixed_width_batches(cuda, m):
    """Pieces cut into tiles of 13 words (16 a row, each at another
    alignment) and folded in two batches of terms, one on the 16-byte path
    and one on the 4-byte path, in both orders: a later batch reloads what
    the other width wrote."""
    from repro_torch.kernels.parity_xor import ops as pops
    rng = np.random.default_rng(40 + m)
    plan, (n_out, n_src, n_src2, n_base) = mixed_width_gf_plan(rng, m)
    plan._pieces = pops.build_pieces(plan, 13)
    pc = plan.pieces()
    assert pc.length.size == 3 and (np.diff(pc.term_ptr) > 32).all()
    assert (np.diff(pc.piece_tile) >= 12).all()
    srcs = (src, src2) = _words(rng, (n_src,)), _words(rng, (n_src2,))
    base, init = _words(rng, (n_base,)), _words(rng, (n_out,))
    for p in range(3):                  # the batches' congruence, as built
        e = np.arange(pc.term_ptr[p], pc.term_ptr[p + 1])
        first = np.arange(e.size) < 32
        assert np.array_equal((pc.term_src[e] - pc.out[p]) % 4 == 0,
                              first != (p == 1))
    want = gf256_mac_plan_ref(init.clone(), src, src2, base, plan.on("cpu"),
                              0, plan.n_rows, 0)
    for shifts in ((0, 0, 0, 0), (2, 2, 2, 2), (1, 0, 1, 1)):
        bufs = [_at(a, cuda, k) for a, k in zip((init, *srcs, base), shifts)]
        assert all(b.data_ptr() % 16 == 4 * k for b, k in zip(bufs, shifts))
        n0 = _build.LAUNCHES["gf256_mac"]
        gf256_mac_cuda(*bufs, plan)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["gf256_mac"] == n0 + 1
        assert torch.equal(bufs[0].cpu(), want), shifts


@pytest.mark.gpu
def test_gf256_mac_every_coefficient_times_every_byte(cuda):
    """256 groups of one member: group c scales the 256 words whose lanes
    hold every byte value by c."""
    i = np.arange(256, dtype=np.uint64)
    words = (i | ((i + 85) % 256) << np.uint64(8)
             | ((i + 170) % 256) << np.uint64(16)
             | ((i + 255) % 256) << np.uint64(24)).astype(np.uint32) \
        .view(np.int32)
    frames = torch.from_numpy(np.tile(words, (256, 1, 1)))
    coeff = torch.arange(256, dtype=torch.int32)[:, None]
    got = gops.gf256_mac(frames.to(cuda), torch.zeros((256, 256),
                                                      dtype=torch.int32,
                                                      device=cuda), coeff)
    want = np.stack([gf_scale_words_np(words, c) for c in range(256)])
    np.testing.assert_array_equal(got.cpu().numpy(), want)


@pytest.mark.gpu
def test_rs_syndromes_in_several_batches_card_equals_cpu(cuda, monkeypatch):
    """The codec's scrub pass, cut into batches of one group (out_shift),
    flags and returns the same rows on the card as on the CPU."""
    from repro_torch.fabric import rs as rs_mod
    tree, part, lay, codec = _codec("f32", RSCodec, n_parity=2)
    per = 2 * codec.layout.frame_elems
    monkeypatch.setattr(rs_mod, "SYNDROME_BATCH_BYTES", 4 * per)
    x = ta.pack_arena(tree, lay)
    assert codec.n_groups >= 3
    out = {}
    for dev in ("cpu", cuda):
        codec.parity = None
        codec.encode_from_arena(0, x.to(dev), lay)
        bad = x.clone().to(dev)
        bad[lay.blocks[len(lay.blocks) // 2].offset + 3] ^= 1 << 13
        out[str(dev)] = codec.syndromes_from_arena(bad, lay)
    c, g = out["cpu"], out[str(cuda)]
    assert c.groups.size == 1
    np.testing.assert_array_equal(g.groups, c.groups)
    np.testing.assert_array_equal(g.rows, c.rows)


def _tree(kind, seed=0):
    gen = torch.Generator().manual_seed(seed)
    if kind == "colocate":
        net = {"a": torch.randn(40, 40, generator=gen),
               "b": torch.randn(7, generator=gen)}
        return {"net": net, "mu": tree_map(lambda x: x * 0.5, net),
                "nu": tree_map(lambda x: x * x, net)}, ("net", "mu", "nu")
    if kind == "subword":
        return {"h": torch.randn(37, 9, generator=gen).to(torch.bfloat16),
                "f": torch.randn(21, 5, generator=gen).to(torch.float16),
                "q": torch.randint(-128, 127, (19, 3), generator=gen,
                                   dtype=torch.int8),
                "e": torch.randn(11, 7, generator=gen).to(
                    torch.float8_e4m3fn),
                "w": torch.randn(33, 6, generator=gen)}, ()
    return {"big": torch.randn(40, 300, generator=gen),
            "w": torch.randn(50, 6, generator=gen),
            "b": torch.randn(5, generator=gen),
            "s": torch.randn((), generator=gen)}, ()


def _codec(kind, cls=ParityCodec, block_rows=8, **kw):
    tree, col = _tree(kind)
    part = partition_pytree(tree, block_rows, colocate=col)
    lay = ta.build_arena_layout(part)
    view = ClusterView(FailureDomainMap(8, 1, 4), block_device_homes(part, 8))
    return tree, part, lay, cls(part, view, group_size=4, arena_layout=lay,
                                **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["f32", "colocate"])
@pytest.mark.parametrize("m", [1, 2, 3])
def test_gf256_mac_codec_plans_match_plain(cuda, kind, m):
    tree, part, lay, codec = _codec(kind, RSCodec, n_parity=m)
    x = ta.pack_arena(tree, lay)
    enc, syn = codec.gf_plans(lay)
    n = enc.limits()["out_hi"]
    got = gf256_mac_cuda(torch.full((n,), 3, dtype=torch.int32, device=cuda),
                         x.to(cuda), None, None, enc)
    want = gf256_mac_plan_ref(torch.zeros((n,), dtype=torch.int32), x, None,
                              None, enc.on("cpu"), 0, enc.n_rows, 0)
    assert torch.equal(got.cpu(), want)
    # row 0 of the RS encode is the XOR parity of the same members
    xor = ParityCodec(part, codec.view, group_size=4, arena_layout=lay)
    if np.array_equal(xor.members, codec.members):
        assert torch.equal(got.view(codec.n_groups, m, -1)[:, 0].cpu(),
                           xor.encode_arena(x))
    # syndromes of a corrupted arena, two groups per batch, into a scratch
    bad = x.clone()
    bad[lay.blocks[-1].offset] ^= 1 << 7
    per = m * codec.layout.frame_elems
    for g0 in range(0, codec.n_groups, 2):
        nb = min(2, codec.n_groups - g0)
        k = gf256_mac_cuda(torch.empty((2 * per,), dtype=torch.int32,
                                       device=cuda), bad.to(cuda), None, got,
                           syn, g0, nb, g0 * per)
        p = gf256_mac_plan_ref(torch.empty((2 * per,), dtype=torch.int32),
                               bad, None, want, syn.on("cpu"), g0, nb,
                               g0 * per)
        assert torch.equal(k[:nb * per].cpu(), p[:nb * per])
    # a decode of up to m erasures in every group, from both sources
    codec.parity = got.view(codec.n_groups, m, -1)
    codec.encoded_step = 0
    lost = np.zeros((part.total_blocks,), bool)
    for row in codec.members:
        ids = row[row >= 0]
        lost[ids[:min(m, ids.size)]] = True
    blocks, words = codec.reconstruct_from_arena(x.to(cuda), lay, lost,
                                                 ~lost)
    codec.parity = want.view(codec.n_groups, m, -1)
    blocks_p, words_p = codec.reconstruct_from_arena(x, lay, lost, ~lost)
    assert np.array_equal(blocks, blocks_p)
    assert torch.equal(words.cpu(), words_p)
    ab = lay.ab_arrays()
    off = 0
    for a in blocks:                     # the lost blocks' own words
        n_a, o = int(ab["payload"][a]), int(ab["offset"][a])
        assert torch.equal(words_p[off:off + n_a], x[o:o + n_a])
        off += n_a


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["f32", "colocate", "subword"])
def test_fused_maintain_cuda_matches_plain(cuda, kind):
    tree, part, lay, codec = _codec(kind)
    z_tree, _ = _tree(kind, seed=1)
    metas = fops.leaf_group_metas(part, codec.layout, codec.group_of)
    fe = codec.layout.frame_elems
    n = codec.n_groups * fe
    par_k = torch.zeros((n,), dtype=torch.int32, device=cuda)
    par_p = torch.zeros((n,), dtype=torch.int32)
    n0 = _build.LAUNCHES["fused_maintain"]
    for x, z, leaf, meta in zip(tree_leaves(tree), tree_leaves(z_tree),
                                part.leaves, metas):
        t_k = fops.leaf_tables(meta, leaf.n_blocks, cuda)
        t_p = fops.leaf_tables(meta, leaf.n_blocks, torch.device("cpu"))
        rep_k, sc_k = fused_maintain_cuda(x.to(cuda), z.to(cuda), par_k, t_k,
                                          part.block_rows, meta.col, fe)
        rep_p, sc_p = fused_maintain_ref(x, z, par_p, t_p, part.block_rows,
                                         meta.col, fe)
        assert torch.equal(rep_k.cpu().view(torch.uint8)
                           if rep_k.element_size() == 1 else rep_k.cpu(),
                           rep_p.view(torch.uint8)
                           if rep_p.element_size() == 1 else rep_p), leaf.name
        torch.testing.assert_close(sc_k.cpu(), sc_p, rtol=1e-4, atol=1e-6,
                                   equal_nan=True)
        again = fused_maintain_cuda(x.to(cuda), z.to(cuda), None, t_k,
                                    part.block_rows, meta.col, fe)[1]
        assert torch.equal(again.nan_to_num(0.0), sc_k.nan_to_num(0.0))
    torch.cuda.synchronize()
    assert _build.LAUNCHES["fused_maintain"] == n0 + 2 * len(metas)
    assert torch.equal(par_k.cpu(), par_p)
    # the folded parity is the codec's encode of the same tree
    codec.encode(0, tree)
    assert torch.equal(par_p.view(codec.n_groups, fe), codec.parity)


def _image_tree(seed):
    """A tree of the dtypes the parity holds as f32 images, ragged at
    block_rows 8, beside one f32 leaf."""
    gen = torch.Generator().manual_seed(seed)
    return {"d": torch.randn(30, 7, generator=gen, dtype=torch.float64),
            "i": torch.randint(-2**40, 2**40, (19, 5), generator=gen),
            "m": torch.rand(13, 9, generator=gen) > 0.5,
            "c": torch.randn(21, 3, generator=gen, dtype=torch.complex64),
            "k": torch.randn(9, 4, generator=gen, dtype=torch.complex128),
            "w": torch.randn(20, 4, generator=gen)}


@pytest.mark.gpu
def test_fused_maintain_image_dtypes_take_the_kernel(cuda):
    """bool, f64, int64 and complex leaves run the kernel, one launch per
    leaf: replicas in their own dtype and the parity bit for bit, scores
    within rtol 1e-4 (f32 sums in another order)."""
    tree, z_tree = _image_tree(3), _image_tree(4)
    part = partition_pytree(tree, 8)
    fab = CheckpointFabric(part, FabricConfig())
    assert fab.arena_layout is None
    fn = fab._fused_maintain_fn()
    n0 = _build.LAUNCHES["fused_maintain"]
    rep_k, sc_k, par_k = fn(tree_map(lambda v: v.to(cuda), tree),
                            tree_map(lambda v: v.to(cuda), z_tree))
    torch.cuda.synchronize()
    assert _build.LAUNCHES["fused_maintain"] == n0 + len(tree)
    rep_p, sc_p, par_p = fn(tree, z_tree)
    assert torch.equal(par_k.cpu(), par_p)
    for k in tree:
        assert rep_k[k].dtype == tree[k].dtype
        assert torch.equal(rep_k[k].cpu(), rep_p[k]), k
    torch.testing.assert_close(sc_k.cpu(), sc_p, rtol=1e-4, atol=1e-6)
    fab.parity.encode(0, tree)
    assert torch.equal(par_p, fab.parity.parity)


def _fabric_run(device, cfg, fail):
    tree, _ = _tree("f32")
    tree = tree_map(lambda v: v.to(device), tree)
    pol = CheckpointPolicy(fraction=0.125, full_interval=1, block_rows=8,
                           strategy=SelectionStrategy.PRIORITY)
    ctl = FTController(tree, pol, fabric=cfg, device=device)
    gen = torch.Generator().manual_seed(4)
    for step in range(1, 4):
        tree = tree_map(lambda v: v + 1e-2 * torch.randn(
            v.shape, generator=gen).to(device), tree)
        ctl.maintain(step, tree)
        ctl.maybe_checkpoint(step, tree)
    fab = ctl.fabric
    if fail == "hosts":
        l0, f0 = fab.domain_failure("host", 0)
        l1, f1 = fab.domain_failure("host", 2)
        lost, failed = l0 | l1, np.unique(np.concatenate([f0, f1]))
    else:
        failed = np.unique([fab.view.homes[0], fab.replicas.replica_homes[0]])
        lost = np.isin(fab.view.homes, failed)
    rec, info = ctl.on_failure(tree, lost, failed_devices=failed, step=3)
    return tree_map(lambda v: v.cpu(), rec), info


@pytest.mark.gpu
@pytest.mark.parametrize("cfg,fail", [
    (dict(n_devices=8, devices_per_host=1, hosts_per_rack=4, rs_parity=2,
          replicate=False), "hosts"),
    (dict(rs_parity=2), "homes"),
    (dict(arena=False), "homes"),
    (dict(arena=False, rs_parity=2), "homes")])
def test_fabric_recovery_card_equals_cpu(cuda, cfg, fail):
    rec_c, info_c = _fabric_run(cuda, FabricConfig(**cfg), fail)
    rec_h, info_h = _fabric_run("cpu", FabricConfig(**cfg), fail)
    assert info_c["tier_counts"] == info_h["tier_counts"]
    assert info_c["tier_counts"]["PARITY"] > 0
    assert info_c["tier_sq"]["PARITY"] == 0.0
    for k in rec_c:
        assert torch.equal(rec_c[k], rec_h[k]), k
