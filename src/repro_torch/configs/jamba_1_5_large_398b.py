"""jamba-1.5-large-398b [hybrid] — 72L d_model=8192 64H (GQA kv=8) d_ff=24576
vocab=65536, MoE 16e top-2.  Mamba+attention 1:7 interleave (1 attention layer
per 8), MoE every other layer. [arXiv:2403.19887; hf]
"""
from repro_torch.configs.base import MambaConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24_576,
    vocab_size=65_536,
    moe=MoEConfig(n_experts=16, top_k=2, d_expert=24_576, moe_period=2),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
    attn_period=8,             # layer i is attention iff i % 8 == 4
    attn_offset=4,
    rope="none",               # jamba attention layers carry no positional encoding
    act="silu",
    source="arXiv:2403.19887; hf",
)
