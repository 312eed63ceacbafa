"""The SSD scan kernel's plain version and the full scan, port against
reference.

- ``ssd_intra_ref`` on the reference's test sweep (``tests/test_kernels.py``)
  against the reference's Pallas kernel in interpret mode and its jnp
  oracle: rtol 2e-4, atol 2e-4, the sweep's own tolerance (f32 sums in
  another order).
- ``ops.ssd_chunked_kernel`` on the CPU (the plain intra-chunk version
  plus the inter-chunk recurrence) against the reference's
  ``ssd_chunked_kernel(interpret=True)`` and ``models.ssm.ssd_chunked``,
  with and without an initial state: rtol 1e-4, atol 1e-4.
- The port's ``models.ssm.ssd_chunked`` is that function.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.kernels.ssd_scan.kernel import ssd_intra_pallas
from repro.kernels.ssd_scan.ops import ssd_chunked_kernel as j_chunked_kernel
from repro.kernels.ssd_scan.ref import ssd_intra_ref as j_intra_ref
from repro.models import ssm as j_ssm
from repro.sharding import single_device_ctx
from repro_torch.configs import get_config
from repro_torch.kernels.ssd_scan.ops import ssd_chunked_kernel, ssd_intra
from repro_torch.kernels.ssd_scan.ref import ssd_intra_ref
from repro_torch.models import ssm

SWEEP = [(2, 2, 16, 3, 8, 16), (1, 4, 32, 4, 16, 32), (2, 1, 8, 1, 4, 8),
         (1, 2, 64, 2, 32, 64)]


def _intra_inputs(dims, seed):
    B, nc, Q, H, P, N = dims
    rng = np.random.default_rng(seed)
    la = (-np.abs(rng.normal(size=(B, nc, Q, H))) * 0.1).astype(np.float32)
    dt = np.abs(rng.normal(size=(B, nc, Q, H))).astype(np.float32)
    x = rng.normal(size=(B, nc, Q, H, P)).astype(np.float32)
    Bm = rng.normal(size=(B, nc, Q, N)).astype(np.float32)
    Cm = rng.normal(size=(B, nc, Q, N)).astype(np.float32)
    return la, dt, x, Bm, Cm


@pytest.mark.parametrize("dims", SWEEP)
def test_ssd_intra_ref_matches_pallas_and_oracle(dims):
    ins = _intra_inputs(dims, seed=sum(dims))
    y, st = ssd_intra_ref(*map(torch.from_numpy, ins))
    y_ops, st_ops = ssd_intra(*map(torch.from_numpy, ins))
    assert torch.equal(y, y_ops) and torch.equal(st, st_ops)
    for fn in (lambda *a: ssd_intra_pallas(*a, interpret=True), j_intra_ref):
        jy, jst = fn(*map(jnp.asarray, ins))
        assert y.shape == jy.shape and st.shape == jst.shape
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=2e-4,
                                   atol=2e-4)
        np.testing.assert_allclose(st.numpy(), np.asarray(jst), rtol=2e-4,
                                   atol=2e-4)


def _scan_inputs(B, S, H, P, N, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(B, S, H)))).astype(np.float32)
    A = (-np.exp(rng.normal(size=(H,)))).astype(np.float32)
    Bm = rng.normal(size=(B, S, N)).astype(np.float32)
    Cm = rng.normal(size=(B, S, N)).astype(np.float32)
    h0 = rng.normal(size=(B, H, P, N)).astype(np.float32)
    return x, dt, A, Bm, Cm, h0


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("B,S,H,P,N,Q", [(2, 48, 3, 8, 16, 16),
                                         (1, 64, 4, 32, 16, 32)])
def test_ssd_chunked_kernel_matches_reference(B, S, H, P, N, Q, with_h0):
    x, dt, A, Bm, Cm, h0 = _scan_inputs(B, S, H, P, N, seed=S + Q)
    h0 = h0 if with_h0 else None
    t = [torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)]
    y, hf = ssd_chunked_kernel(*t, chunk=Q, h0=None if h0 is None
                               else torch.from_numpy(h0))
    j = [jnp.asarray(a) for a in (x, dt, A, Bm, Cm)]
    jh0 = None if h0 is None else jnp.asarray(h0)
    jy, jhf = j_chunked_kernel(*j, chunk=Q, h0=jh0, interpret=True)
    cfg = dataclasses.replace(j_get_config("mamba2-370m", reduced=True),
                              ssm_chunk=Q)
    oy, ohf = j_ssm.ssd_chunked(*j, cfg, single_device_ctx(), h0=jh0)
    for want_y, want_h in ((jy, jhf), (oy, ohf)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(hf.numpy(), np.asarray(want_h), rtol=1e-4,
                                   atol=1e-4)
    # the model's scan is this function at the config's chunk
    pcfg = dataclasses.replace(get_config("mamba2-370m", reduced=True),
                               ssm_chunk=Q)
    my, mhf = ssm.ssd_chunked(*t, pcfg, h0=None if h0 is None
                              else torch.from_numpy(h0))
    assert torch.equal(my, y) and torch.equal(mhf, hf)


def test_ssd_chunked_kernel_rejects_ragged_sequence():
    x, dt, A, Bm, Cm, _ = _scan_inputs(1, 40, 2, 4, 8, seed=0)
    with pytest.raises(ValueError, match="divisible"):
        ssd_chunked_kernel(*map(torch.from_numpy, (x, dt, A, Bm, Cm)),
                           chunk=16)
