"""llama4-maverick-400b-a17b [moe] — 48L d_model=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 128e top-1, early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202_048,
    # Maverick interleaves dense / MoE every other layer
    # (interleave_moe_layer_step=2) -- that is what makes 128e x 48L come out
    # at ~400B total / ~17B active.
    moe=MoEConfig(n_experts=128, top_k=1, d_expert=8192,
                  n_shared_experts=1, d_shared=8192, moe_period=2),
    rope="rope",
    rope_theta=500_000.0,
    act="silu",
    source="hf:meta-llama/Llama-4-Scout-17B-16E; unverified",
)
