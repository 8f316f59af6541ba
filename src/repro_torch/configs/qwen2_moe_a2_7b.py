"""qwen2-moe-a2.7b [moe] — 24L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=151936, MoE 60e top-4; 4 shared + 60 routed top-4.
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=151_936,
    qkv_bias=True,
    moe=MoEConfig(n_experts=60, top_k=4, d_expert=1408,
                  n_shared_experts=4, d_shared=1408, moe_period=1),
    rope="rope",
    rope_theta=1_000_000.0,
    act="silu",
    source="hf:Qwen/Qwen1.5-MoE-A2.7B; hf",
)
