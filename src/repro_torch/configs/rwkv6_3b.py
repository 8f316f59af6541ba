"""rwkv6-3b [ssm] — 32L d_model=2560 (attention-free) d_ff=8960 vocab=65536.
RWKV-6 "Finch": data-dependent decay linear attention, token shift.
[arXiv:2404.05892; hf]
"""
from repro_torch.configs.base import ModelConfig, RWKVConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=40,                # d_model / head_size
    n_kv_heads=40,
    head_dim=64,
    d_ff=8960,
    vocab_size=65_536,
    rwkv=RWKVConfig(head_size=64, decay_lora=64),
    rope="none",
    norm="layernorm",
    gated_mlp=False,           # rwkv channel-mix: square relu, 2 mats
    act="silu",
    source="arXiv:2404.05892; hf",
)
