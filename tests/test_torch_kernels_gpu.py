"""Each CUDA kernel against its plain PyTorch version, on the card.

Every test here is marked ``gpu`` and skips where there is no CUDA device.
The file imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch and the CUDA toolkit:

    python -m pytest -q --noconftest -m gpu tests/test_torch_kernels_gpu.py

Copies are compared bit for bit (as raw bytes); block_dist within rtol
1e-4, since its f32 sums run in another order than the plain version's.
"""
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.block_dist.kernel import block_dist_cuda
from repro_torch.kernels.block_dist.ref import block_dist_ref
from repro_torch.kernels.fused_maintain.kernel import scatter_save_cuda
from repro_torch.kernels.fused_maintain.ref import scatter_save_ref
from repro_torch.kernels.masked_restore.kernel import masked_restore_cuda
from repro_torch.kernels.masked_restore.ref import masked_restore_ref


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
