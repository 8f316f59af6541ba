"""Config system of the PyTorch port: model architecture and hardware
constants.

Own copy of ``repro/configs/base.py``, trimmed to the dense decoder-only
family this slice serves: its per-block options (qkv bias, softcaps, norm
kind, activation, gating, tied or scaled embeddings, post-block norms) run
as in the reference, while a sliding window or M-RoPE raises until its
slice lands.  The MoE, MLA, Mamba, RWKV and encoder-decoder extensions come
with their slices.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Literal, Optional

AttnKind = Literal["full", "window"]


def pad_to(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


@dataclass(frozen=True)
class LayerSpec:
    """Structural plan for one transformer block."""
    mixer: str = "attn"
    attn: AttnKind = "full"
    mlp: str = "dense"


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                      # 0 -> d_model // n_heads
    # --- attention details ---
    qkv_bias: bool = False
    rope: Literal["rope", "mrope", "none"] = "rope"
    rope_theta: float = 10_000.0
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    sliding_window: Optional[int] = None   # window size for "window" layers
    window_pattern: int = 0                # >0: layer i is full iff i % pattern == pattern-1
    # --- misc ---
    norm: Literal["rmsnorm", "layernorm"] = "rmsnorm"
    norm_eps: float = 1e-5
    act: Literal["silu", "gelu"] = "silu"
    gated_mlp: bool = True
    tie_embeddings: bool = False
    scale_embeddings: bool = False         # gemma: embed * sqrt(d_model)
    post_block_norms: bool = False         # gemma2 sandwich norms
    vocab_pad_mult: int = 256
    dtype: str = "bfloat16"
    source: str = ""

    @property
    def head_dim_eff(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def v_head_dim_eff(self) -> int:
        return self.head_dim_eff

    @property
    def padded_vocab(self) -> int:
        return pad_to(self.vocab_size, self.vocab_pad_mult)

    def layer_plan(self) -> tuple[LayerSpec, ...]:
        specs = []
        for i in range(self.n_layers):
            if self.window_pattern > 0 and self.sliding_window:
                attn: AttnKind = ("full" if i % self.window_pattern
                                  == self.window_pattern - 1 else "window")
            elif self.sliding_window:
                attn = "window"
            else:
                attn = "full"
            specs.append(LayerSpec(attn=attn))
        return tuple(specs)

    def kv_cache_bytes(self, batch: int, seq: int, bytes_per: int = 2) -> int:
        """Paper §1 cost model: K and V of every attention layer."""
        total = 0
        for spec in self.layer_plan():
            eff_seq = seq
            if spec.attn == "window" and self.sliding_window:
                eff_seq = min(seq, self.sliding_window)
            total += batch * eff_seq * 2 * self.n_kv_heads * self.head_dim_eff
        return int(total * bytes_per)

    def reduced(self, *, n_layers: int | None = None) -> "ModelConfig":
        """Smoke-test-scale config of the same structural family."""
        kv_ratio = max(1, self.n_heads // max(self.n_kv_heads, 1))
        n_heads = 4
        return replace(
            self, name=self.name + "-reduced", n_layers=n_layers or 2,
            d_model=64, n_heads=n_heads,
            n_kv_heads=max(1, n_heads // min(kv_ratio, n_heads)),
            head_dim=16, d_ff=128, vocab_size=512, vocab_pad_mult=64,
            sliding_window=8 if self.sliding_window else None)


@dataclass(frozen=True)
class HWSpec:
    name: str
    peak_flops: float          # per-chip dense bf16 FLOP/s (tensor cores)
    peak_flops_fp32: float     # per-chip fp32 FLOP/s outside the tensor cores
    hbm_bw: float              # bytes/s
    hbm_bytes: float


# NVIDIA H100 SXM data sheet: 989 TFLOP/s dense bf16, 67 TFLOP/s fp32,
# 3.35 TB/s HBM3, 80 GiB.
H100 = HWSpec("h100-sxm", peak_flops=989e12, peak_flops_fp32=67e12,
              hbm_bw=3.35e12, hbm_bytes=80 * 2**30)
