"""gemma2-27b [dense] — 46L d_model=4608 32H (GQA kv=16) d_ff=36864 vocab=256000.
Local(4096)/global alternating attention, logit softcaps.
[arXiv:2408.00118; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=36_864,
    vocab_size=256_000,
    sliding_window=4096,
    window_pattern=2,          # odd layers full/global, even layers local
    attn_softcap=50.0,
    final_softcap=30.0,
    rope="rope",
    rope_theta=10_000.0,
    act="gelu",
    tie_embeddings=True,
    scale_embeddings=True,
    post_block_norms=True,
    source="arXiv:2408.00118; hf",
)
