"""Each CUDA kernel against its plain PyTorch version, on the card.

Every test here is marked ``gpu`` and skips where there is no CUDA device.
The file imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch and the CUDA toolkit:

    python -m pytest -q --noconftest -m gpu tests/test_torch_kernels_gpu.py

Copies are compared bit for bit (as raw bytes); block_dist within rtol
1e-4, since its f32 sums run in another order than the plain version's.
The grouped forms (one launch for a whole tree) run on a tree of ragged,
single-block, 0-d, bf16, uint8, colocated and odd-offset leaves, and must
give the same bits on every run; masked_restore's also with an arena as
its source, and with masks all clear and all set.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.arena import (arena_restore, arena_restore_ref,
                                    build_arena_layout, pack_arena)
from repro_torch.core.blocks import partition_pytree
from repro_torch.kernels import _build
from repro_torch.kernels.block_dist.ops import tree_block_dist
from repro_torch.kernels.block_dist.ref import block_dist_tree_ref
from repro_torch.kernels.fused_maintain.ops import tree_scatter_save
from repro_torch.kernels.leaf_table import block_dist_table
from repro_torch.utils.tree import tree_leaves, tree_map
from repro_torch.kernels.block_dist.kernel import block_dist_cuda
from repro_torch.kernels.block_dist.ref import block_dist_ref
from repro_torch.kernels.fused_maintain.kernel import scatter_save_cuda
from repro_torch.kernels.fused_maintain.ref import scatter_save_ref
from repro_torch.kernels.masked_restore.kernel import masked_restore_cuda
from repro_torch.kernels.masked_restore.ops import tree_masked_restore
from repro_torch.kernels.masked_restore.ref import (masked_restore_ref,
                                                    tree_masked_restore_ref)
from repro_torch.kernels.leaf_table import restore_table


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("n_blocks,elems", [(12, 196608), (13, 700),
                                            (3, 37)])
def test_block_dist_cuda_matches_plain(cuda, n_blocks, elems):
    g = torch.Generator(device=cuda).manual_seed(0)
    a = torch.randn((n_blocks, elems), generator=g, device=cuda)
    b = torch.randn((n_blocks, elems), generator=g, device=cuda)
    n0 = _build.LAUNCHES["block_dist"]
    got = block_dist_cuda(a, b)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["block_dist"] == n0 + 1
    torch.testing.assert_close(got, block_dist_ref(a, b), rtol=1e-4, atol=0)
    assert torch.equal(got, block_dist_cuda(a, b))       # same on every run


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32, torch.uint8, torch.float64])
@pytest.mark.parametrize("rows,width,block_rows", [(61, 24, 8), (1536, 256, 128),
                                                   (7, 3, 2)])
def test_scatter_save_cuda_matches_plain(cuda, dtype, rows, width, block_rows):
    g = torch.Generator(device=cuda).manual_seed(1)
    src = torch.randint(0, 255, (rows, width), generator=g, device=cuda) \
        .to(dtype)
    dst = torch.zeros_like(src)
    n_blocks = -(-rows // block_rows)
    ids = torch.tensor([n_blocks - 1, 0, n_blocks - 1], dtype=torch.int32,
                       device=cuda)
    got = scatter_save_cuda(dst.clone(), src, ids, block_rows)
    want = scatter_save_ref(dst.clone(), src, ids, block_rows)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32, torch.uint8, torch.float64])
@pytest.mark.parametrize("rows,width,block_rows", [
    (12, 196608, 1), (11, 301, 1), (1, 3, 1),       # (n_blocks, E) form
    (196, 10, 128), (10, 1, 128), (61, 24, 8), (1536, 256, 128)])
def test_masked_restore_cuda_matches_plain(cuda, dtype, rows, width,
                                           block_rows):
    g = torch.Generator(device=cuda).manual_seed(2)
    dst = torch.randint(0, 255, (rows, width), generator=g,
                        device=cuda).to(dtype)
    src = torch.randint(0, 255, (rows, width), generator=g,
                        device=cuda).to(dtype)
    n_blocks = -(-rows // block_rows)
    mask = torch.rand((n_blocks,), generator=g, device=cuda) < 0.5
    mask[-1] = True                      # the ragged last block from src
    got = masked_restore_cuda(dst, src, mask, block_rows)
    torch.cuda.synchronize()
    want = masked_restore_ref(dst, src, mask, block_rows)
    assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))


def _grouped_tree(seed: int, device) -> dict:
    """A tree with every case the grouped kernels walk: ragged, single-block
    and 0-d leaves, bf16 and uint8 ones, CNN-style colocated subtrees, a
    multi-chunk block (fc: 16 x 3000 values a block) and leaves that are
    views 4 bytes (f32) and 1 byte (uint8) past an aligned address."""
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    net = {"conv": f(37, 3, 4), "bias": f(5), "fc": f(40, 3000)}
    tree = {"net": net, "mu": {k: f(*v.shape) for k, v in net.items()},
            "nu": {k: f(*v.shape) for k, v in net.items()},
            "x": {"big": f(300, 6), "scalar": f(),
                  "half": f(40, 12).to(torch.bfloat16)}}
    tree = tree_map(lambda t: t.to(device), tree)
    odd = torch.zeros((1 + 45 * 3,), device=device)
    odd[1:] = f(45 * 3).to(device)
    raw = torch.zeros((1 + 33 * 5,), dtype=torch.uint8, device=device)
    raw[1:] = torch.from_numpy(rng.integers(0, 256, 33 * 5, dtype=np.uint8)
                               ).to(device)
    tree["x"]["odd"] = odd[1:].view(45, 3)
    tree["x"]["bytes"] = raw[1:].view(33, 5)
    return tree


COLOCATE = ("net", "mu", "nu")


@pytest.mark.gpu
@pytest.mark.parametrize("block_rows", [8, 16])
def test_block_dist_tree_cuda_matches_plain(cuda, block_rows):
    a, b = _grouped_tree(3, cuda), _grouped_tree(4, cuda)
    part = partition_pytree(a, block_rows, colocate=COLOCATE)
    al, bl = tree_leaves(a), tree_leaves(b)
    n0 = _build.LAUNCHES["block_dist"]
    got = tree_block_dist(al, bl, part)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["block_dist"] == n0 + 1      # one call a tree
    want = block_dist_tree_ref(al, bl, part)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=0)
    assert torch.equal(got, tree_block_dist(al, bl, part))   # same bits
    # new tensors at new addresses: the pointer column is uploaded again
    a2 = tree_map(lambda t: t.clone() * 2, a)
    want2 = block_dist_tree_ref(tree_leaves(a2), bl, part)
    got2 = tree_block_dist(tree_leaves(a2), bl, part)
    torch.testing.assert_close(got2, want2, rtol=1e-4, atol=0)
    assert torch.equal(tree_block_dist(al, bl, part), got)
    # another stream gets its own pointer column
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        got3 = tree_block_dist(tree_leaves(a2), bl, part)
    torch.cuda.synchronize()
    dev = al[0].device
    assert set(block_dist_table(part)._on) == {
        (dev, torch.cuda.default_stream(dev).cuda_stream),
        (dev, side.cuda_stream)}
    assert torch.equal(got3, got2)


@pytest.mark.gpu
@pytest.mark.parametrize("block_rows", [8, 16])
def test_block_dist_tree_cuda_reads_bf16_in_place(cuda, block_rows):
    """Pairs of bf16 leaves are read in place, widened on the card, with no
    f32 copy: within rtol 1e-4 of the plain version, and where the bf16
    pair and its f32 copies both take vector loads (aligned leaves: each
    thread takes the same values in the same order) the same bits as the
    call on the copies. The tree has a multi-chunk bf16 block, a ragged
    leaf, a view 2 bytes past an aligned address (scalar loads, its fresh
    f32 copy vector ones) and a bf16 leaf against an f32 one (that pair
    through f32 copies)."""
    g = torch.Generator(device=cuda).manual_seed(block_rows)

    def tree():
        odd = torch.randn((1 + 45 * 3,), generator=g, device=cuda)
        t = {"fc": torch.randn((40, 3000), generator=g, device=cuda),
             "ragged": torch.randn((37, 5), generator=g, device=cuda),
             "odd": odd.to(torch.bfloat16)[1:].view(45, 3),
             "mixed": torch.randn((20, 8), generator=g, device=cuda)}
        return {k: v.to(torch.bfloat16) for k, v in t.items()}
    a, b = tree(), tree()
    b["mixed"] = b["mixed"].float()
    assert a["odd"].data_ptr() % 8 == 2
    part = partition_pytree(a, block_rows)
    al, bl = tree_leaves(a), tree_leaves(b)
    got = tree_block_dist(al, bl, part)
    f32 = tree_block_dist([x.float() for x in al], [x.float() for x in bl],
                          part)
    for leaf in part.leaves:
        if leaf.name in ("['fc']", "['ragged']"):
            blocks = slice(leaf.offset, leaf.offset + leaf.n_blocks)
            assert torch.equal(got[blocks], f32[blocks]), leaf.name
    torch.testing.assert_close(got, block_dist_tree_ref(al, bl, part),
                               rtol=1e-4, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("block_rows", [8, 16])
def test_scatter_save_tree_cuda_matches_plain(cuda, block_rows):
    dst, src = _grouped_tree(5, cuda), _grouped_tree(6, cuda)
    part = partition_pytree(dst, block_rows, colocate=COLOCATE)
    rng = np.random.default_rng(7)
    idx = np.union1d(rng.integers(0, part.total_blocks, 9),
                     [g for l in part.leaves
                      for g in (l.offset, l.offset + l.n_blocks - 1)])
    cpu_dst = tree_map(lambda t: t.cpu(), dst)
    want, want_moved = tree_scatter_save(cpu_dst, tree_map(
        lambda t: t.cpu(), src), idx, part)
    n0 = _build.LAUNCHES["scatter_save"]
    got, moved = tree_scatter_save(dst, src, idx, part)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["scatter_save"] == n0 + 1    # one launch a save
    assert moved == want_moved
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        assert torch.equal(g.reshape(-1).view(torch.uint8).cpu(),
                           w.reshape(-1).view(torch.uint8))


def _same_bytes(got: list, want: list) -> bool:
    return all(torch.equal(g.reshape(-1).view(torch.uint8),
                           w.reshape(-1).view(torch.uint8))
               for g, w in zip(got, want))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["random", "none", "all"])
@pytest.mark.parametrize("block_rows", [8, 16])
def test_masked_restore_tree_cuda_matches_plain(cuda, block_rows, kind):
    dst, src = _grouped_tree(8, cuda), _grouped_tree(9, cuda)
    part = partition_pytree(dst, block_rows, colocate=COLOCATE)
    n = part.total_blocks
    mask = {"random": np.random.default_rng(10).random(n) < 0.5,
            "none": np.zeros((n,), bool), "all": np.ones((n,), bool)}[kind]
    m = torch.from_numpy(mask).to(cuda)
    n0 = _build.LAUNCHES["masked_restore"]
    got = tree_leaves(tree_masked_restore(dst, src, m, part))
    torch.cuda.synchronize()
    assert _build.LAUNCHES["masked_restore"] == n0 + 1  # one launch a tree
    want = tree_leaves(tree_masked_restore_ref(dst, src, m, part))
    assert _same_bytes(got, want)
    assert _same_bytes(tree_leaves(tree_masked_restore(dst, src, m, part)),
                       got)                              # same bits again
    # another stream gets its own pointer column
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        got2 = tree_leaves(tree_masked_restore(dst, src, m, part))
    torch.cuda.synchronize()
    dev = got[0].device
    table = restore_table(part, tuple(x.dtype for x in tree_leaves(dst)))
    assert set(table._on) == {
        (dev, torch.cuda.default_stream(dev).cuda_stream),
        (dev, side.cuda_stream)}
    assert _same_bytes(got2, want)


@pytest.mark.gpu
def test_arena_restore_cuda_matches_plain(cuda):
    src, dst = _grouped_tree(11, cuda), _grouped_tree(12, cuda)
    part = partition_pytree(src, 8, colocate=COLOCATE)
    layout = build_arena_layout(part)
    arena = pack_arena(src, layout)
    mask = np.random.default_rng(13).random(part.total_blocks) < 0.4
    names = [l.name for l in part.leaves]
    scalar = part.leaves[names.index("['x']['scalar']")]
    mask[scalar.offset] = False                          # left untouched
    n0 = _build.LAUNCHES["masked_restore"]
    got = tree_leaves(arena_restore(dst, arena, mask, layout))
    torch.cuda.synchronize()
    assert _build.LAUNCHES["masked_restore"] == n0 + 1
    want = tree_leaves(arena_restore_ref(dst, arena, mask, layout))
    assert _same_bytes(got, want)
    i = names.index("['x']['scalar']")
    assert got[i] is tree_leaves(dst)[i]
