"""llama4-maverick-400b-a17b [moe] — MoE top-1 + shared expert, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E].

48L d_model=5120 40H (GQA kv=8) d_ff=8192 (per expert) vocab=202048,
128 routed experts top-1 + shared expert; dense and MoE layers interleaved (moe_every=2, total ~400B, active ~17B). Early-fusion multimodal embeds
arrive via the stub frontend (text-only input specs exercise the backbone).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab=202048,
    n_experts=128,
    top_k=1,
    shared_expert=True,
    moe_every=2,          # llama4 interleaves dense and MoE layers
    d_ff_dense=16384,
    sliding_window=4096,
    microbatch=4,
    attn_chunk=512,
    opt_moment_dtype="bfloat16",
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
))
