"""chatglm2-6b — the paper's own evaluation model (§5.1). 28L d_model=4096
32H (multi-query kv=2) d_ff=13696 vocab=65024.  Used by the paper-table
benchmarks (Table 1, Figs. 4-5). [hf:THUDM/chatglm2-6b; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chatglm2-6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    head_dim=128,
    d_ff=13_696,
    vocab_size=65_024,
    qkv_bias=True,
    rope="rope",
    rope_theta=10_000.0,
    act="silu",
    source="hf:THUDM/chatglm2-6b; hf (paper §5.1 model)",
)
