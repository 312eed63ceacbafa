"""ModelConfig dataclass + registry for the assigned architectures.

A copy of ``repro.configs.base`` (same fields, same ``reduced()``), so that
the port imports nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

_REGISTRY: Dict[str, "ModelConfig"] = {}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int = 0            # 0 for attention-free
    n_kv_heads: int = 0
    d_head: int = 0             # 0 -> d_model // n_heads
    d_ff: int = 0
    vocab: int = 32000
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 1_000_000.0
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    shared_expert: bool = False
    moe_every: int = 1          # 2 = alternate dense/MoE layers (llama4)
    d_ff_dense: int = 0         # FFN width of the dense layers when interleaved
    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    conv_width: int = 4
    ssm_chunk: int = 128
    # hybrid (zamba2): shared attention block applied every N ssm layers
    attn_every: int = 0
    # enc-dec (whisper)
    enc_layers: int = 0
    enc_seq: int = 0
    # vlm (internvl2): stub vision frontend emits n_patches embeddings of
    # vit_dim which a learned projector maps to d_model
    n_patches: int = 0
    vit_dim: int = 0
    # attention variant: 0 = full causal; >0 = sliding window (sub-quadratic)
    sliding_window: int = 0
    # numerics / training
    dtype: str = "bfloat16"
    remat: bool = True
    loss_chunk: int = 4096      # tokens per logits chunk (vocab-sharded xent)
    microbatch: int = 1         # grad-accumulation splits per train step
    opt_moment_dtype: str = "float32"  # bf16 halves optimizer HBM (400B-class)
    attn_chunk: int = 1024      # flash q/kv tile (drop when heads can't shard)
    # beyond-paper performance variants (the three §Perf hillclimbs;
    # default False = paper-faithful baseline)
    triangle_prefill: bool = False    # causal prefill skips masked-out tiles
    moe_reduce_scatter: bool = False  # MoE combine via reduce-scatter not AR
    kv_quant: bool = False            # int8 KV cache, per-token-head scales
    moe_no_fsdp: bool = False         # expert weights expert-parallel only (re-homed)
    source: str = ""            # citation

    @property
    def head_dim(self) -> int:
        if self.d_head:
            return self.d_head
        return self.d_model // max(self.n_heads, 1)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def has_attention(self) -> bool:
        return self.n_heads > 0

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: 2 layers, d_model<=512, <=4 experts."""
        d_model = min(self.d_model, 256)
        n_heads = min(self.n_heads, 4) if self.n_heads else 0
        n_kv = min(self.n_kv_heads, max(1, n_heads // 2)) if self.n_kv_heads else 0
        return dataclasses.replace(
            self,
            n_layers=2,
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            d_head=(64 if self.d_head else 0),
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab=min(self.vocab, 1024),
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            d_ff_dense=min(self.d_ff_dense, 512) if self.d_ff_dense else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_headdim=32 if self.ssm_state else self.ssm_headdim,
            ssm_chunk=32 if self.ssm_state else self.ssm_chunk,
            attn_every=min(self.attn_every, 2) if self.attn_every else 0,
            enc_layers=min(self.enc_layers, 2) if self.enc_layers else 0,
            enc_seq=min(self.enc_seq, 64) if self.enc_seq else 0,
            n_patches=min(self.n_patches, 16) if self.n_patches else 0,
            vit_dim=min(self.vit_dim, 128) if self.vit_dim else 0,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
            dtype="float32",
            loss_chunk=512,
            microbatch=1,
        )


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str, reduced: bool = False) -> ModelConfig:
    cfg = _REGISTRY[name]
    return cfg.reduced() if reduced else cfg


def list_configs() -> list[str]:
    return sorted(_REGISTRY)
