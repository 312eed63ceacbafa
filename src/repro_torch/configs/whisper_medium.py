"""whisper-medium [audio] — enc-dec, conv frontend (stub) [arXiv:2212.04356].

24L d_model=1024 16H (MHA kv=16) d_ff=4096 vocab=51865. The mel-spectrogram
+ conv feature extractor is a STUB: input_specs() provides precomputed frame
embeddings (1500 frames, the 30 s Whisper window). long_500k is skipped for
this arch (see DESIGN.md — 524288-token decode is out of family for the
30 s enc-dec format).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper-medium",
    family="audio",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=51865,
    enc_layers=24,
    enc_seq=1500,
    rope_theta=0.0,   # whisper uses learned/sinusoidal positions, not RoPE
    microbatch=2,
    source="arXiv:2212.04356",
))
