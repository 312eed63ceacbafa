"""Model-layout sliding-window attention.

Takes the model's (B, S, Hq, Dh) / (B, S, Hk, Dh) layout, regroups the
query heads for GQA into (B·Hk, G, S, Dh) and runs the plain version on
CPU tensors (and meta ones, the dry run's), the CUDA kernel otherwise. The port's
``models.transformer.prefill`` calls it on the card with ``window=S`` for
causal attention and the config's window for a ring prefill.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.sw_attention.kernel import sw_attention_cuda
from repro_torch.kernels.sw_attention.ref import sw_attention_ref


def sw_attention(q, k, v, *, window: int) -> torch.Tensor:
    """q: (B, S, Hq, Dh); k, v: (B, S, Hk, Dh) -> (B, S, Hq, Dh) in q's
    dtype. The query group ``G = Hq / Hk`` is the tensors' own (on a model
    axis, the rank's); where ``Hq`` is 0 (a rank that holds no query
    heads) the output is empty and nothing runs."""
    B, S, Hq, Dh = q.shape
    Hk = k.shape[2]
    if not Hq:
        return q.clone()
    G = Hq // Hk
    qg = q.transpose(1, 2).reshape(B * Hk, G, S, Dh)
    kg = k.transpose(1, 2).reshape(B * Hk, S, Dh)
    vg = v.transpose(1, 2).reshape(B * Hk, S, Dh)
    if q.device.type in ("cpu", "meta"):
        o = sw_attention_ref(qg, kg, vg, window=window)
    else:
        o = sw_attention_cuda(qg.contiguous(), kg.contiguous(),
                              vg.contiguous(), window=window)
    o = o.reshape(B, Hk, G, S, Dh).permute(0, 3, 1, 2, 4)
    return o.reshape(B, S, Hq, Dh).to(q.dtype)
