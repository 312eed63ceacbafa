"""internvl2-76b [vlm] — InternViT + InternLM2 backbone [arXiv:2404.16821].

80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256. The vision frontend
(InternViT-6B) is a STUB per the brief: input_specs() provides precomputed
patch embeddings (vit_dim=3200) which the learned projector maps to d_model.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab=128256,
    n_patches=1024,
    vit_dim=3200,
    sliding_window=4096,   # long_500k variant opt-in (noted in DESIGN.md)
    microbatch=4,
    source="arXiv:2404.16821",
))
