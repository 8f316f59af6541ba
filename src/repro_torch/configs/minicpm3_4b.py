"""minicpm3-4b [dense] — 62L d_model=2560 40H (kv=40) d_ff=6400 vocab=73448.
Multi-head Latent Attention (MLA): KV cache stores the compressed latent.
[hf:openbmb/MiniCPM3-4B; hf]
"""
from repro_torch.configs.base import MLAConfig, ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b",
    family="dense",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    d_ff=6400,
    vocab_size=73_448,
    mla=MLAConfig(q_lora_rank=768, kv_lora_rank=256,
                  qk_nope_head_dim=64, qk_rope_head_dim=32, v_head_dim=64),
    rope="rope",
    rope_theta=10_000.0,
    act="silu",
    tie_embeddings=True,
    source="hf:openbmb/MiniCPM3-4B; hf",
)
