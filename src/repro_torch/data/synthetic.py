"""Synthetic datasets for the classic models (paper §5.1 stand-ins) and
random LM batches.

The numpy generators of ``repro.data.synthetic`` that the classic models
use, copied so that the port imports nothing of the JAX package. Given the
same ``np.random.Generator`` they produce byte-identical data.
``lm_batch`` draws LM tokens with a torch generator. ``input_specs`` and
``shape_params`` name the dry run's input shapes (``launch.dryrun``):
tensors on the ``meta`` device, with the shapes and dtypes of the
reference's ``ShapeDtypeStruct`` stand-ins, hold no memory.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


def classification_data(rng: np.random.Generator, n: int = 2000, dim: int = 784,
                        n_classes: int = 10, sep: float = 2.0):
    """Gaussian-cluster classification (MNIST/CoverType stand-in)."""
    centers = rng.normal(0, sep, (n_classes, dim))
    y = rng.integers(0, n_classes, n)
    x = centers[y] + rng.normal(0, 1.0, (n, dim))
    return x.astype(np.float32), y.astype(np.int32)


def ratings_matrix(rng: np.random.Generator, m: int = 600, n: int = 900,
                   rank: int = 5, noise: float = 0.05, density: float = 0.1):
    """Low-rank ratings (MovieLens/Jester stand-in). Returns (R, mask)."""
    L = rng.normal(0, 1.0, (m, rank))
    R = rng.normal(0, 1.0, (rank, n))
    full = L @ R + noise * rng.normal(0, 1.0, (m, n))
    mask = rng.random((m, n)) < density
    return (full * mask).astype(np.float32), mask.astype(np.float32)


def lda_corpus(rng: np.random.Generator, n_docs: int = 200, vocab: int = 500,
               n_topics: int = 10, doc_len_mean: int = 80):
    """Documents sampled from the LDA generative model (20news stand-in).

    Returns (tokens (n_docs, max_len) int32 padded with -1, doc_lens).
    """
    alpha, beta = 0.5, 0.1
    topic_word = rng.dirichlet([beta] * vocab, n_topics)
    doc_lens = np.maximum(10, rng.poisson(doc_len_mean, n_docs))
    max_len = int(doc_lens.max())
    tokens = np.full((n_docs, max_len), -1, np.int32)
    for d in range(n_docs):
        theta = rng.dirichlet([alpha] * n_topics)
        zs = rng.choice(n_topics, doc_lens[d], p=theta)
        for i, z in enumerate(zs):
            tokens[d, i] = rng.choice(vocab, p=topic_word[z])
    return tokens, doc_lens.astype(np.int32)


def image_batch(rng: np.random.Generator, n: int = 512, size: int = 28,
                n_classes: int = 10):
    """Class-dependent structured images (MNIST stand-in for the CNN)."""
    y = rng.integers(0, n_classes, n)
    x = rng.normal(0, 0.3, (n, size, size, 1)).astype(np.float32)
    xs = np.linspace(-1, 1, size)
    xx, yy = np.meshgrid(xs, xs)
    for c in range(n_classes):
        pat = np.sin((c + 1) * np.pi * xx) * np.cos((c + 1) * np.pi * yy)
        x[y == c] += pat[None, :, :, None].astype(np.float32)
    return x, y.astype(np.int32)


def lm_batch(generator: torch.Generator, cfg, batch: int, seq: int,
             device: DeviceLike = None) -> dict:
    """Random LM batch: int32 ``tokens`` and ``labels`` of (batch, seq) in
    [0, cfg.vocab), and standard-normal ``patches`` of (batch,
    cfg.n_patches, cfg.vit_dim) for the vlm family or ``frames`` of
    (batch, cfg.enc_seq, cfg.d_model) for the audio family, in the config's
    dtype (bfloat16 or float32), drawn with ``generator`` on its device and placed on
    ``device`` (``cuda`` unless asked otherwise). The draws differ from the
    reference's ``jax.random`` ones; tests hand both packages the same
    numpy inputs instead."""
    dev = resolve_device(device)
    out = {}
    for key in ("tokens", "labels"):
        out[key] = torch.randint(0, cfg.vocab, (batch, seq),
                                 generator=generator, device=generator.device,
                                 dtype=torch.int32).to(dev)
    extra = {"vlm": ("patches", (batch, cfg.n_patches, cfg.vit_dim)),
             "audio": ("frames", (batch, cfg.enc_seq, cfg.d_model))}
    if cfg.family in extra:
        key, shape = extra[cfg.family]
        dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
        out[key] = torch.randn(shape, generator=generator,
                               device=generator.device,
                               dtype=torch.float32).to(dev, dtype)
    return out


# ---------------------------------------------------------------------------
# the dry run's input shapes (meta tensors: no allocation)
# ---------------------------------------------------------------------------

SHAPES = {
    "train_4k": dict(seq=4096, batch=256, kind="train"),
    "prefill_32k": dict(seq=32768, batch=32, kind="prefill"),
    "decode_32k": dict(seq=32768, batch=128, kind="decode"),
    "long_500k": dict(seq=524288, batch=1, kind="decode"),
    # reduced shapes for CPU-side integration tests
    "smoke_train": dict(seq=64, batch=2, kind="train"),
    "smoke_decode": dict(seq=64, batch=2, kind="decode"),
}


def _lm_batch_struct(cfg, batch: int, seq: int) -> dict:
    """``lm_batch``'s keys, shapes and dtypes as meta tensors."""
    d = {"tokens": torch.empty((batch, seq), dtype=torch.int32,
                               device="meta"),
         "labels": torch.empty((batch, seq), dtype=torch.int32,
                               device="meta")}
    dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    if cfg.family == "vlm":
        d["patches"] = torch.empty((batch, cfg.n_patches, cfg.vit_dim),
                                   dtype=dtype, device="meta")
    if cfg.family == "audio":
        d["frames"] = torch.empty((batch, cfg.enc_seq, cfg.d_model),
                                  dtype=dtype, device="meta")
    return d


def batch_specs(cfg, kind: str, batch: int, seq: int) -> dict:
    """The global batch of a step of ``kind`` as meta tensors: a train or
    prefill step's ``lm_batch`` keys, a decode step's one new token
    ``(batch, 1)``."""
    if kind in ("train", "prefill"):
        return _lm_batch_struct(cfg, batch, seq)
    return {"tokens": torch.empty((batch, 1), dtype=torch.int32,
                                  device="meta")}


def input_specs(cfg, shape_name: str) -> dict:
    """:func:`batch_specs` of a named input shape."""
    s = SHAPES[shape_name]
    return batch_specs(cfg, s["kind"], s["batch"], s["seq"])


def shape_params(shape_name: str) -> dict:
    """A named input shape's ``seq``, ``batch`` and ``kind``."""
    return dict(SHAPES[shape_name])
