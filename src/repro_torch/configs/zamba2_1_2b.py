"""zamba2-1.2b [hybrid] — Mamba2 backbone + shared attention block
[arXiv:2411.15242].

38L d_model=2048 32H (GQA kv=32) d_ff=8192 vocab=32000, ssm_state=64. The
shared transformer block (full attention + MLP, weights reused) is applied
every 6 Mamba2 layers, zamba2-style.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=32000,
    ssm_state=64,
    ssm_headdim=64,
    attn_every=6,
    microbatch=4,
    source="arXiv:2411.15242",
))
