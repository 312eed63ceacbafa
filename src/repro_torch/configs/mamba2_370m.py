"""mamba2-370m [ssm] — SSD (state-space duality) [arXiv:2405.21060].

48L d_model=1024 (attention-free) vocab=50280, ssm_state=128.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=50280,
    ssm_state=128,
    ssm_headdim=64,
    source="arXiv:2405.21060",
))
