"""Plain PyTorch version of the sliding-window attention kernel."""
import math

import torch

NEG_INF = -1e30


def sw_attention_ref(q, k, v, *, window: int) -> torch.Tensor:
    """Banded causal attention (materialises the (S, S) scores).

    q: (BH, G, S, Dh); k, v: (BH, S, Dh). Returns (BH, G, S, Dh) f32.
    """
    BH, G, S, Dh = q.shape
    scale = 1.0 / math.sqrt(Dh)
    s = torch.einsum("bgqd,bkd->bgqk", q.to(torch.float32),
                     k.to(torch.float32)) * scale
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(S, device=q.device)[None, :]
    mask = (kpos <= qpos) & (qpos - kpos < window)
    s = torch.where(mask, s, torch.full((), NEG_INF, device=s.device))
    p = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
    p = torch.where(mask, p, torch.zeros((), device=p.device))
    p = p / torch.clamp_min(torch.sum(p, dim=-1, keepdim=True), 1e-30)
    return torch.einsum("bgqk,bkd->bgqd", p, v.to(torch.float32))
