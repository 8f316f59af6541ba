"""whisper-medium [audio] — 24L d_model=1024 16H (kv=16) d_ff=4096 vocab=51865.
Encoder-decoder; conv frontend is a STUB: a prefill takes precomputed
frame embeddings. [arXiv:2212.04356; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="encdec",
    n_layers=24,
    n_encoder_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=51_865,
    frontend="audio_stub",
    cross_kv_len=1536,
    rope="none",              # whisper uses learned/sinusoidal positions
    norm="layernorm",
    act="gelu",
    gated_mlp=False,
    qkv_bias=True,
    tie_embeddings=True,
    source="arXiv:2212.04356; unverified",
)
