"""The paper's experiment models (§5.1): QP, MLR, MF (ALS), LDA (Gibbs), CNN.

The port of ``repro.models.classic``. Each model is an iterative-convergent
algorithm behind one protocol, so the SCAR experiments run identically over
all of them:

- ``init(gen)``             -> params tree (the state SCAR checkpoints)
- ``draw(gen, i)``          -> iteration i's random inputs: batch indices
                               (MLR, CNN), Gumbel noise of the topic
                               sampler (LDA), None (QP, MF)
- ``update(params, d, i)``  -> params' given those inputs
- ``step(params, gen, i)``  =  ``update(params, draw(gen, i), i)``
- ``loss(params)``          -> scalar convergence metric (lower = better)
- ``x_star()``              -> optimum / reference params
- ``norm_aux``              -> per-leaf aux for the scaled-TV norm (LDA)

Splitting ``step`` lets a test hand the port the reference's own draws.
Generators are CPU ``torch.Generator``s, so a run draws the same inputs on
every device; parameters and data live on the model's ``device``, which is
``cuda`` unless the caller asks for another.

The datasets are the reference's numpy generators with the same seeds, so
the data are byte-identical. Layouts at the public surface are the
reference's: images NHWC, convolution weights HWIO.

The CNN turns TF32 off for cuDNN convolutions and CUDA matmuls
(``torch.backends.cudnn.allow_tf32`` and
``torch.backends.cuda.matmul.allow_tf32``) when it is built, so that its
float32 arithmetic is full float32 on the card, as in the reference.

LDA note: the parallel approximation of collapsed Gibbs sampling
(resample all token topics given the current counts, then rebuild counts),
as in the reference; its categorical draw is ``argmax(logits + gumbel)``,
which is how ``jax.random.categorical`` draws.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.blocks import tree_sq_norm
from repro_torch.data import synthetic
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.utils.tree import tree_map

PyTree = Any


def fold_in(seed: int, i: int) -> torch.Generator:
    """The CPU generator of iteration ``i`` of a run seeded ``seed``."""
    return torch.Generator().manual_seed((int(seed) << 32) + int(i))


def _reference_run(init, draw, update, loss, n_iters: int, target_iter: int,
                   margin: float = 1.001, seed: int = 97):
    """One unperturbed reference run. Returns (x_star, eps, trajectory).

    eps is the loss reached at ``target_iter`` (+ tiny margin), so an
    unperturbed run converges in roughly ``target_iter`` iterations.
    """
    p = init(torch.Generator().manual_seed(0))
    traj = []
    for i in range(1, n_iters + 1):
        p = update(p, draw(fold_in(seed, i), i), i)
        traj.append(float(loss(p)))
    eps = traj[min(target_iter, n_iters) - 1] * margin
    x_star = tree_map(torch.clone, p)
    return x_star, eps, traj


@dataclasses.dataclass(frozen=True)
class IterativeModel:
    name: str
    init: Callable[[torch.Generator], PyTree]
    draw: Callable[[torch.Generator, int], Any]
    update: Callable[[PyTree, Any, int], PyTree]
    loss: Callable[[PyTree], torch.Tensor]
    x_star: Callable[[], PyTree]
    eps: float                      # paper-style convergence criterion on loss
    device: torch.device
    norm_aux: Optional[dict] = None
    block_rows: int = 8             # fine-grained blocks for small models
    colocate: tuple = ()            # co-partitioned state groups

    def step(self, params: PyTree, gen: torch.Generator, i: int) -> PyTree:
        return self.update(params, self.draw(gen, i), i)

    def distance(self, params: PyTree) -> float:
        """||x − x*|| in the flat L2 sense (for c-estimation / bounds)."""
        return float(torch.sqrt(tree_sq_norm(params, self.x_star())))


def with_draws(model: IterativeModel, draws: dict,
               eps: Optional[float] = None,
               x_star: Optional[PyTree] = None) -> IterativeModel:
    """``model`` fed recorded iteration inputs: iteration ``i`` of a run
    seeded ``seed`` (whose generator is ``fold_in(seed, i)``) takes
    ``draws[(seed, i)]``, a numpy array (batch indices, Gumbel noise), in
    place of its own draw. ``eps`` and ``x_star`` (a numpy tree) replace
    the model's where given: they come from a reference run with the
    draws of whoever recorded them. A test hands the port the reference's
    draws this way."""
    def draw(gen: torch.Generator, i: int):
        s = gen.initial_seed()
        d = np.asarray(draws[(s >> 32, s & 0xFFFFFFFF)])
        t = torch.from_numpy(d.astype(np.int64) if d.dtype.kind in "iu"
                             else d.copy())
        return t.to(model.device)

    kw = {"draw": draw}
    if eps is not None:
        kw["eps"] = float(eps)
    if x_star is not None:
        star = tree_map(lambda x: torch.from_numpy(np.array(x)).to(
            model.device), x_star)
        kw["x_star"] = lambda: star
    return dataclasses.replace(model, **kw)


def _batch_draw(n: int, batch: int, device: torch.device):
    def draw(gen: torch.Generator, i: int) -> torch.Tensor:
        return torch.randperm(n, generator=gen)[:batch].to(device)
    return draw


def _no_draw(gen: torch.Generator, i: int) -> None:
    return None


# ---------------------------------------------------------------------------
# QP: gradient descent on a quadratic (Figure 3)
# ---------------------------------------------------------------------------

def make_qp(dim: int = 4, seed: int = 0, lr: Optional[float] = None,
            cond: float = 10.0, device: DeviceLike = None) -> IterativeModel:
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    U, _ = np.linalg.qr(rng.normal(size=(dim, dim)))
    eig = np.linspace(1.0, cond, dim)
    Q = (U * eig) @ U.T
    b = rng.normal(size=(dim,))
    x_opt = np.linalg.solve(Q, b)
    Qt = torch.as_tensor(Q, dtype=torch.float32, device=dev)
    bt = torch.as_tensor(b, dtype=torch.float32, device=dev)
    xt = torch.as_tensor(x_opt, dtype=torch.float32, device=dev)
    if lr is None:
        lr = 1.0 / (eig.max() + eig.min())   # optimal GD step for quadratics

    def update(params, draws, i):
        x = params["x"]
        return {"x": x - lr * (Qt @ x - bt)}

    def loss(params):
        x = params["x"]
        return 0.5 * x @ Qt @ x - bt @ x

    def init(gen):
        return {"x": (torch.randn((dim,), generator=gen) * 5.0).to(dev)}

    return IterativeModel(
        name="qp", init=init, draw=_no_draw, update=update, loss=loss,
        x_star=lambda: {"x": xt},
        eps=float(0.5 * x_opt @ Q @ x_opt - b @ x_opt) + 1e-6,
        device=dev, block_rows=1,
    )


# ---------------------------------------------------------------------------
# MLR: multinomial logistic regression with SGD (Figures 5/6/7/8)
# ---------------------------------------------------------------------------

def make_mlr(n: int = 2000, dim: int = 196, n_classes: int = 10,
             batch: int = 500, lr: float = 0.01, seed: int = 0,
             ref_iters: int = 120, device: DeviceLike = None) -> IterativeModel:
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    x_np, y_np = synthetic.classification_data(rng, n=n, dim=dim,
                                               n_classes=n_classes)
    X = torch.from_numpy(x_np).to(dev)
    Y = torch.from_numpy(y_np).to(torch.int64).to(dev)

    def xent(w, xb, yb):
        logits = xb @ w["w"] + w["b"]
        return torch.mean(torch.logsumexp(logits, dim=-1)
                          - logits.gather(1, yb[:, None])[:, 0])

    def grad(w, xb, yb):
        # d mean(logsumexp - picked) / d logits = (softmax - onehot) / B
        logits = xb @ w["w"] + w["b"]
        g = torch.softmax(logits, dim=-1)
        g[torch.arange(g.shape[0], device=g.device), yb] -= 1.0
        g = g / xb.shape[0]
        return {"w": xb.T @ g, "b": torch.sum(g, dim=0)}

    def update(params, idx, i):
        g = grad(params, X[idx], Y[idx])
        return {k: params[k] - lr * g[k] for k in params}

    def loss(params):
        return xent(params, X, Y) * n   # paper reports total cross-entropy

    def init(gen):
        return {"w": torch.zeros((dim, n_classes), device=dev),
                "b": torch.zeros((n_classes,), device=dev)}

    draw = _batch_draw(n, batch, dev)
    star, eps, _ = _reference_run(init, draw, update, loss, ref_iters,
                                  target_iter=60)
    return IterativeModel(
        name="mlr", init=init, draw=draw, update=update, loss=loss,
        x_star=lambda: star, eps=eps, device=dev, block_rows=8,
    )


# ---------------------------------------------------------------------------
# MF: matrix factorization by alternating least squares (Figures 7/8)
# ---------------------------------------------------------------------------

def make_mf(m: int = 400, n: int = 600, rank: int = 5, reg: float = 0.1,
            seed: int = 0, device: DeviceLike = None) -> IterativeModel:
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    R_np, M_np = synthetic.ratings_matrix(rng, m=m, n=n, rank=rank)
    R = torch.from_numpy(R_np).to(dev)
    M = torch.from_numpy(M_np).to(dev)
    eye = torch.eye(rank, device=dev)

    def solve_rows(A, target, mask):
        # ridge solve per row: rows of target explained by A's columns
        Aw = A[None, :, :] * mask[:, :, None]                 # (rows, na, r)
        G = Aw.transpose(1, 2) @ A + reg * eye                # (rows, r, r)
        rhs = (Aw.transpose(1, 2) @ target[:, :, None])[..., 0]
        return torch.linalg.solve(G, rhs)

    def update(params, draws, i):
        L, Rt = params["L"], params["R"]                       # (m,r), (r,n)
        L_new = solve_rows(Rt.T, R, M)                          # (m, r)
        R_new = solve_rows(L_new, R.T, M.T).T.contiguous()      # (r, n)
        return {"L": L_new, "R": R_new}

    def loss(params):
        pred = params["L"] @ params["R"]
        return torch.sum(((pred - R) * M) ** 2)

    def init(gen):
        return {"L": torch.rand((m, rank), generator=gen).to(dev),
                "R": torch.rand((rank, n), generator=gen).to(dev)}

    star, eps, _ = _reference_run(init, _no_draw, update, loss, 80,
                                  target_iter=60)
    return IterativeModel(
        name="mf", init=init, draw=_no_draw, update=update, loss=loss,
        x_star=lambda: star, eps=eps, device=dev, block_rows=8,
    )


# ---------------------------------------------------------------------------
# LDA: (parallel-approximate) collapsed Gibbs sampling (Figures 6/7/8)
# ---------------------------------------------------------------------------

def make_lda(n_docs: int = 150, vocab: int = 300, n_topics: int = 10,
             alpha: float = 1.0, beta: float = 1.0, doc_len_mean: int = 80,
             seed: int = 0, device: DeviceLike = None) -> IterativeModel:
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    tokens_np, doc_lens_np = synthetic.lda_corpus(
        rng, n_docs=n_docs, vocab=vocab, n_topics=n_topics,
        doc_len_mean=doc_len_mean)
    tokens = torch.from_numpy(tokens_np).to(dev)            # (D, maxlen), -1 pad
    valid = tokens >= 0
    tok_safe = torch.where(valid, tokens, 0).to(torch.int64)
    D, maxlen = tokens.shape
    K, V = n_topics, vocab

    def counts_from_z(z):
        """z: (D, maxlen) topic assignments -> (doc_topic, word_topic)."""
        zoh = F.one_hot(z.to(torch.int64), K).to(torch.float32) \
            * valid[..., None]
        doc_topic = torch.sum(zoh, dim=1)                    # (D, K)
        wt = torch.zeros((V, K), device=dev)
        wt.index_add_(0, tok_safe.reshape(-1), zoh.reshape(-1, K))
        return doc_topic, wt

    def draw(gen, i):
        # Gumbel noise for argmax(logits + g), drawn as jax.random.gumbel
        # does: -log(-log(u)) with u uniform in [tiny, 1)
        u = torch.rand((D, maxlen, K), generator=gen)
        u = u.clamp_min(torch.finfo(torch.float32).tiny)
        return (-torch.log(-torch.log(u))).to(dev)

    def update(params, gumbel, i):
        doc_topic, word_topic = counts_from_z(params["z"])
        topic_tot = torch.sum(word_topic, dim=0)              # (K,)
        p_wt = (word_topic[tok_safe] + beta) / (topic_tot + V * beta)
        p_dt = doc_topic[:, None, :] + alpha
        logits = torch.log(p_wt * p_dt + 1e-30)
        z_new = torch.argmax(logits + gumbel, dim=-1).to(torch.int32)
        z_new = torch.where(valid, z_new, torch.zeros_like(z_new))
        doc_topic_new, _ = counts_from_z(z_new)
        theta = doc_topic_new + alpha
        theta = theta / torch.sum(theta, dim=-1, keepdim=True)
        return {"z": z_new, "theta": theta}

    def loss(params):
        """Negative predictive log-likelihood given current counts."""
        doc_topic, word_topic = counts_from_z(params["z"])
        topic_tot = torch.sum(word_topic, dim=0)
        phi = (word_topic + beta) / (topic_tot + V * beta)    # (V, K)
        theta = doc_topic + alpha
        theta = theta / torch.sum(theta, dim=-1, keepdim=True)
        pw = torch.einsum("dmk,dk->dm", phi[tok_safe], theta)
        return -torch.sum(torch.where(valid, torch.log(pw + 1e-30),
                                      torch.zeros_like(pw)))

    def init(gen):
        z = torch.randint(0, K, (D, maxlen), generator=gen,
                          dtype=torch.int32).to(dev)
        z = torch.where(valid, z, torch.zeros_like(z))
        doc_topic, _ = counts_from_z(z)
        theta = doc_topic + alpha
        theta = theta / torch.sum(theta, dim=-1, keepdim=True)
        return {"z": z, "theta": theta}

    star, eps, _ = _reference_run(init, draw, update, loss, 100,
                                  target_iter=60)
    return IterativeModel(
        name="lda", init=init, draw=draw, update=update, loss=loss,
        x_star=lambda: star, eps=eps, device=dev,
        norm_aux={"['theta']": np.asarray(doc_lens_np, np.float32)},
        block_rows=8,
    )


# ---------------------------------------------------------------------------
# CNN: 2 conv + 3 FC with Adam (Figures 7/8)
# ---------------------------------------------------------------------------

def make_cnn(n: int = 512, size: int = 16, n_classes: int = 10,
             batch: int = 64, lr: float = 1e-3, seed: int = 0,
             device: DeviceLike = None) -> IterativeModel:
    dev = resolve_device(device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(seed)
    x_np, y_np = synthetic.image_batch(rng, n=n, size=size, n_classes=n_classes)
    X = torch.from_numpy(x_np).to(dev)                       # NHWC
    Y = torch.from_numpy(y_np).to(torch.int64).to(dev)

    c1, c2, f1, f2, f3 = 8, 16, 128, 64, n_classes
    flat = (size // 4) * (size // 4) * c2

    def init_net(gen):
        def he(shape, fan):
            return (torch.randn(shape, generator=gen)
                    * np.sqrt(2.0 / fan)).to(dev)
        return {
            "conv1": he((3, 3, 1, c1), 9),                    # HWIO
            "conv2": he((3, 3, c1, c2), 9 * c1),
            "fc1": he((flat, f1), flat),
            "fc2": he((f1, f2), f1),
            "fc3": he((f2, f3), f2),
            "b1": torch.zeros((f1,), device=dev),
            "b2": torch.zeros((f2,), device=dev),
            "b3": torch.zeros((f3,), device=dev),
        }

    def conv_same(h, w_hwio):
        # NCHW activations, HWIO weights -> OIHW; 3x3 stride 1 "SAME" = pad 1
        return F.conv2d(h, w_hwio.permute(3, 2, 0, 1), padding=1)

    def forward(p, xb):
        h = xb.permute(0, 3, 1, 2)                            # NHWC -> NCHW
        h = F.max_pool2d(F.relu(conv_same(h, p["conv1"])), 2)
        h = F.max_pool2d(F.relu(conv_same(h, p["conv2"])), 2)
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)     # flatten as NHWC
        h = F.relu(h @ p["fc1"] + p["b1"])
        h = F.relu(h @ p["fc2"] + p["b2"])
        return h @ p["fc3"] + p["b3"]

    def xent(p, xb, yb):
        logits = forward(p, xb)
        return torch.mean(torch.logsumexp(logits, dim=-1)
                          - logits.gather(1, yb[:, None])[:, 0])

    b1m, b2m, eps_adam = 0.9, 0.999, 1e-8

    def update(params, idx, i):
        net, mu, nu, t = params["net"], params["mu"], params["nu"], params["t"]
        names = sorted(net)
        leaves = [net[k].detach().requires_grad_(True) for k in names]
        with torch.enable_grad():
            loss_b = xent(dict(zip(names, leaves)), X[idx], Y[idx])
            grads = dict(zip(names, torch.autograd.grad(loss_b, leaves)))
        t = t + 1
        mu = {k: b1m * mu[k] + (1 - b1m) * grads[k] for k in names}
        nu = {k: b2m * nu[k] + (1 - b2m) * grads[k] ** 2 for k in names}
        tf = t.to(torch.float32)
        net = {k: net[k] - lr * (mu[k] / (1 - b1m ** tf))
               / (torch.sqrt(nu[k] / (1 - b2m ** tf)) + eps_adam)
               for k in names}
        return {"net": net, "mu": mu, "nu": nu, "t": t}

    def loss(params):
        with torch.no_grad():
            return xent(params["net"], X, Y) * n

    def init(gen):
        net = init_net(gen)
        return {"net": net,
                "mu": {k: torch.zeros_like(v) for k, v in net.items()},
                "nu": {k: torch.zeros_like(v) for k, v in net.items()},
                "t": torch.zeros((), dtype=torch.int32, device=dev)}

    draw = _batch_draw(n, batch, dev)
    star, eps, _ = _reference_run(init, draw, update, loss, 120,
                                  target_iter=60)
    return IterativeModel(
        name="cnn", init=init, draw=draw, update=update, loss=loss,
        x_star=lambda: star, eps=eps, device=dev, block_rows=4,
        colocate=("net", "mu", "nu"),   # Adam moments fail/recover WITH weights
    )


_MODEL_CACHE: dict = {}


REGISTRY = {"qp": make_qp, "mlr": make_mlr, "mf": make_mf,
            "lda": make_lda, "cnn": make_cnn}


def make_model(name: str, device: DeviceLike = None, **kw) -> IterativeModel:
    """Build (and cache: reference runs are not free) a classic model on
    ``device`` (``cuda`` unless asked otherwise)."""
    dev = resolve_device(device)
    key = (name, str(dev), tuple(sorted(kw.items())))
    if key not in _MODEL_CACHE:
        _MODEL_CACHE[key] = REGISTRY[name](device=dev, **kw)
    return _MODEL_CACHE[key]
