"""Architecture config registry.

``get_config(name)`` returns the full assigned config;
``get_config(name, reduced=True)`` returns the CPU-smoke variant
(≤2 layers, d_model ≤ 512, ≤4 experts).

The port's copy of ``repro.configs``: the same ten configurations as plain
data. ``repro_torch.models.get_model`` serves and trains every family,
with the perf variants (``kv_quant``, ``triangle_prefill``) on the dense,
MoE and VLM ones.
"""
from repro_torch.configs.base import ModelConfig, register, get_config, list_configs

# import for registration side effects
from repro_torch.configs import (internvl2_76b, zamba2_1_2b, granite_8b,
                           command_r_plus_104b, qwen3_moe_235b_a22b,
                           mamba2_370m, llama4_maverick_400b_a17b,
                           qwen2_1_5b, yi_9b, whisper_medium)

__all__ = ["ModelConfig", "register", "get_config", "list_configs"]
