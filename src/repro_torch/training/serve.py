"""Batched serving: prefill a batch of prompts, then decode.

The port of ``repro.training.serve.Server`` for one device. The decode
loop is host-driven, one ``decode_step`` per token, and the cache stays on
the device across steps. PyTorch runs eagerly, so nothing is jitted; on
the card the prefill runs the family's CUDA kernels (``ssd_intra`` for the
SSM family, ``sw_attention`` for the dense, MoE and VLM ones, both for the
hybrid, ``sw_attention`` in the encoder-decoder's decoder). Every key of
the batch reaches the prefill: a VLM's ``patches`` (its decode positions
then go on from ``S + n_patches``), an encoder-decoder's ``frames``.
The server treats the cache as opaque: under ``cfg.kv_quant`` it is the
int8 cache with its scales; ``cfg.triangle_prefill`` changes nothing,
since every causal prefill already skips the tiles above the diagonal.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import get_model
from repro_torch.utils.tree import tree_leaves

PyTree = Any


class Server:
    """Serves ``params`` (a tree on ``device``, ``cuda`` unless asked
    otherwise) of the model ``cfg`` describes."""

    def __init__(self, cfg: ModelConfig, params: PyTree,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        for x in tree_leaves(params):
            if x.device != self.device:
                raise ValueError(f"params lie on {x.device}, the server "
                                 f"runs on {self.device}")
        self.cfg = cfg
        self.ops = get_model(cfg)
        self.params = params

    @torch.no_grad()
    def generate(self, batch: dict, n_new: int, temperature: float = 0.0,
                 generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
        """Returns (B, n_new) int32 generated token ids.

        Greedy when ``temperature`` is 0: ``argmax``, the first index on
        ties as in jnp. Otherwise each token is drawn from
        softmax(logits / temperature) with ``generator`` (a torch generator
        on the server's device); these draws cannot agree with the
        reference's ``jax.random.categorical`` ones.
        """
        cfg, params = self.cfg, self.params
        # every key of the batch (a VLM's ``patches``, an encoder-decoder's
        # ``frames``)
        logits, cache = self.ops.prefill(
            params, {k: v.to(self.device) for k, v in batch.items()}, cfg)
        out = [self._pick(logits, 0.0, None)]
        for _ in range(n_new - 1):
            logits, cache = self.ops.decode_step(params, cache, out[-1], cfg)
            out.append(self._pick(logits, temperature, generator))
        return torch.cat(out, dim=1)

    @staticmethod
    def _pick(logits: torch.Tensor, temperature: float,
              generator: Optional[torch.Generator]) -> torch.Tensor:
        last = logits[:, -1]
        if temperature > 0:
            probs = torch.softmax(last / temperature, dim=-1)
            tok = torch.multinomial(probs, 1, generator=generator)
        else:
            tok = torch.argmax(last, dim=-1)[:, None]
        return tok.to(torch.int32)
