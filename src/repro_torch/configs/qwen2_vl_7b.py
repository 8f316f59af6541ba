"""qwen2-vl-7b [vlm] — 28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064.
M-RoPE (temporal/height/width sections), dynamic resolution.  Vision frontend
is a STUB: a prefill may take precomputed patch embeddings in place of
token embeddings.
[arXiv:2409.12191; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    head_dim=128,
    d_ff=18_944,
    vocab_size=152_064,
    qkv_bias=True,
    rope="mrope",
    mrope_sections=(16, 24, 24),
    rope_theta=1_000_000.0,
    frontend="vision_stub",
    act="silu",
    source="arXiv:2409.12191; hf",
)
