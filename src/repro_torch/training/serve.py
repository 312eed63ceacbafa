"""Batched serving: prefill a batch of prompts, then decode.

The port of ``repro.training.serve.Server``. The decode loop is
host-driven, one ``decode_step`` per token, and the cache stays on the
device across steps. PyTorch runs eagerly, so nothing is jitted; on the
card the prefill runs the family's CUDA kernels (``ssd_intra`` for the SSM
family, ``sw_attention`` for the dense, MoE and VLM ones, both for the
hybrid, ``sw_attention`` in the encoder-decoder's decoder). Every key of
the batch reaches the prefill: a VLM's ``patches`` (its decode positions
then go on from ``S + n_patches``), an encoder-decoder's ``frames``.
The server treats the cache as opaque: under ``cfg.kv_quant`` it is the
int8 cache with its scales; ``cfg.triangle_prefill`` changes nothing,
since every causal prefill already skips the tiles above the diagonal.

**On a mesh** (``ctx``, a :class:`~repro_torch.sharding.partition.
DistContext` over ``torch.distributed`` ranks) every rank runs the
server: its ``params`` are its model slices
(``sharding.partition.model_slices``), it serves its data shard of the
batch (``partition.batch_rows``) over them, its cache is its slice of the
whole (``partition.state_slices``), and ``generate`` returns the whole
batch's tokens on every rank, gathered over the data line
(``serve_tokens`` in ``distributed.collectives.STATS``). Greedy tokens
agree over a model line by construction: its ranks hold the same logits
bit for bit. A sampled token is drawn at the line's first position and
broadcast over the line (``serve_sample``), so the ranks feed the same
tokens into the next step.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.collectives import data_comm, model_axis
from repro_torch.models import get_model
from repro_torch.sharding.partition import batch_rows, check_tensor_parallel
from repro_torch.utils.tree import tree_leaves

PyTree = Any


class Server:
    """Serves ``params`` (a tree on ``device``, ``cuda`` unless asked
    otherwise) of the model ``cfg`` describes; with ``ctx``, this rank's
    model slices of them (raises ``ValueError`` where the config does not
    split over ``ctx``'s model axis)."""

    def __init__(self, cfg: ModelConfig, params: PyTree,
                 device: DeviceLike = None, ctx=None):
        self.device = resolve_device(device)
        for x in tree_leaves(params):
            if x.device != self.device:
                raise ValueError(f"params lie on {x.device}, the server "
                                 f"runs on {self.device}")
        if ctx is not None:
            check_tensor_parallel(cfg, ctx.tp_size)
        self.cfg, self.ctx = cfg, ctx
        self.ops = get_model(cfg)
        self.params = params

    @torch.no_grad()
    def generate(self, batch: dict, n_new: int, temperature: float = 0.0,
                 generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
        """Returns (B, n_new) int32 generated token ids for the whole
        ``batch`` (on a mesh, the global batch: every rank returns every
        row).

        Greedy when ``temperature`` is 0: ``argmax``, the first index on
        ties as in jnp. Otherwise each token is drawn from
        softmax(logits / temperature) with ``generator`` (a torch generator
        on the server's device; on a mesh the one of each model line's
        first rank); these draws cannot agree with the reference's
        ``jax.random.categorical`` ones.
        """
        cfg, params, ctx = self.cfg, self.params, self.ctx
        n = next(iter(batch.values())).shape[0]
        lo, hi = batch_rows(n, ctx)
        # every key of the batch (a VLM's ``patches``, an encoder-decoder's
        # ``frames``), this rank's data shard of its rows
        shard = {k: v[lo:hi].to(self.device) for k, v in batch.items()}
        logits, cache = self.ops.prefill(params, shard, cfg, ctx)
        out = [self._pick(logits, 0.0, None)]
        for _ in range(n_new - 1):
            logits, cache = self.ops.decode_step(params, cache, out[-1], cfg,
                                                 ctx)
            out.append(self._pick(logits, temperature, generator))
        toks = torch.cat(out, dim=1)
        if hi - lo == n:
            return toks
        comm = data_comm(ctx)
        return comm.all_gather(toks, name="serve_tokens").view(
            comm.n, hi - lo, n_new).reshape(n, n_new)

    def _pick(self, logits: torch.Tensor, temperature: float,
              generator: Optional[torch.Generator]) -> torch.Tensor:
        last = logits[:, -1]
        if temperature <= 0:
            return torch.argmax(last, dim=-1)[:, None].to(torch.int32)
        axis = model_axis(self.ctx)
        if axis is not None and axis.pos != 0:
            # the line's first rank draws; the others take its tokens
            tok = torch.empty((last.shape[0], 1), dtype=torch.int32,
                              device=last.device)
        else:
            probs = torch.softmax(last / temperature, dim=-1)
            tok = torch.multinomial(probs, 1, generator=generator).to(
                torch.int32)
        if axis is not None:
            axis.comm.broadcast(tok, root=0, name="serve_sample")
        return tok
