"""The port's classic models against the JAX package's, at small sizes.

For each of qp, mlr, mf, lda and cnn:

- the synthetic data are byte-equal (same numpy generators, same seeds);
- ``loss`` agrees within rtol 1e-5 on the reference's init params, carried
  across by ``from_numpy_tree``;
- ``update`` fed the reference's own draws agrees within rtol 1e-5 after
  one step and 1e-4 after ten (matmul sums run in another order). An
  entry near zero has no relative precision to keep (an MF ridge solve
  leaves entries of 1e-2 with errors of 1e-6 after one step), so each
  leaf's absolute floor is rtol times its largest magnitude. The
  draws: MLR and CNN take ``jax.random.choice(key, n, (batch,),
  replace=False)`` as the reference's step draws them; LDA takes the
  Gumbel noise ``jax.random.gumbel(key, logits.shape)``, which is exactly
  how ``jax.random.categorical`` samples (``argmax(logits + gumbel)``), so
  both packages resample the same topics.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import synthetic as jsyn
from repro.models import classic as jclassic
from repro_torch.data import synthetic as tsyn
from repro_torch.interop import from_numpy_tree, to_numpy_tree
from repro_torch.models import classic as tclassic
from repro_torch.utils.tree import tree_leaves

SIZES = {
    "qp": dict(dim=6),
    "mlr": dict(n=200, dim=16, n_classes=4, batch=50, ref_iters=10),
    "mf": dict(m=120, n=160, rank=3),
    "lda": dict(n_docs=20, vocab=40, n_topics=4, doc_len_mean=15),
    "cnn": dict(n=64, size=8, batch=16),
}
SEED = 0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while these tests run: the suite runs several
    workers on a few cores, and torch's default of one thread per core in
    each of them oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=sorted(SIZES))
def pair(request):
    name = request.param
    ref = jclassic.make_model(name, **SIZES[name])
    port = tclassic.make_model(name, device="cpu", **SIZES[name])
    return name, ref, port


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _draw(name, port, params_np, key):
    kw = SIZES[name]
    if name in ("mlr", "cnn"):
        idx = jax.random.choice(key, kw["n"], (kw["batch"],), replace=False)
        return torch.from_numpy(np.asarray(idx).astype(np.int64))
    if name == "lda":
        shape = params_np["z"].shape + (kw["n_topics"],)
        return torch.from_numpy(np.array(
            jax.random.gumbel(key, shape, jnp.float32)))
    return None


def _assert_trees_close(got, want, rtol):
    g_leaves = tree_leaves(to_numpy_tree(got))
    w_leaves = jax.tree_util.tree_leaves(_np(want))
    assert len(g_leaves) == len(w_leaves)
    for g, w in zip(g_leaves, w_leaves):
        assert g.dtype == w.dtype and g.shape == w.shape
        if g.dtype.kind in "iu":
            np.testing.assert_array_equal(g, w)
        else:
            scale = float(np.max(np.abs(w))) if w.size else 0.0
            np.testing.assert_allclose(g, w, rtol=rtol, atol=rtol * scale)


def test_synthetic_data_byte_equal():
    for fn, kw in [("classification_data", dict(n=50, dim=7, n_classes=3)),
                   ("ratings_matrix", dict(m=9, n=11, rank=2)),
                   ("lda_corpus", dict(n_docs=6, vocab=20, n_topics=3,
                                       doc_len_mean=12)),
                   ("image_batch", dict(n=10, size=8, n_classes=4))]:
        want = getattr(jsyn, fn)(np.random.default_rng(3), **kw)
        got = getattr(tsyn, fn)(np.random.default_rng(3), **kw)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            assert g.tobytes() == w.tobytes()


def test_loss_agrees(pair):
    name, ref, port = pair
    p_np = _np(ref.init(jax.random.PRNGKey(1)))
    want = float(ref.loss(p_np))
    got = float(port.loss(from_numpy_tree(p_np, "cpu")))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_update_with_reference_draws_agrees(pair):
    name, ref, port = pair
    p_ref = ref.init(jax.random.PRNGKey(1))
    p_port = from_numpy_tree(_np(p_ref), "cpu")
    for i in range(1, 11):
        key = jax.random.fold_in(jax.random.PRNGKey(SEED), i)
        draws = _draw(name, port, _np(p_ref), key)
        p_ref = ref.step(p_ref, key, i)
        p_port = port.update(p_port, draws, i)
        if i == 1:
            _assert_trees_close(p_port, p_ref, rtol=1e-5)
    _assert_trees_close(p_port, p_ref, rtol=1e-4)
    np.testing.assert_allclose(float(port.loss(p_port)),
                               float(ref.loss(p_ref)), rtol=1e-4)


def test_step_is_update_of_draw(pair):
    name, ref, port = pair
    p = port.init(torch.Generator().manual_seed(1))
    a = port.step(p, tclassic.fold_in(SEED, 4), 4)
    b = port.update(p, port.draw(tclassic.fold_in(SEED, 4), 4), 4)
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y)


def test_port_reference_run_converges(pair):
    name, ref, port = pair
    assert np.isfinite(port.eps)
    for x in tree_leaves(port.x_star()):
        assert torch.isfinite(x.to(torch.float32)).all()
        assert x.device.type == "cpu"
