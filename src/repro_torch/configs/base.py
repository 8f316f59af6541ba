"""Config system of the PyTorch port: model architecture, input shapes and
hardware constants.

Own copy of ``repro/configs/base.py``, trimmed to the families the port
serves: the decoder-only family, whose per-block options (qkv bias,
RoPE or M-RoPE, softcaps, sliding-window layers, Multi-head Latent
Attention (``mla``), the capacity-dispatched Mixture-of-Experts MLP
(``moe``), norm kind, activation, gating, tied or scaled embeddings,
post-block norms, the vision stub's embedding input) run as in the
reference, RWKV-6 (``rwkv``), the Mamba hybrid (``mamba`` with
``attn_period`` / ``attn_offset``: layer i attends iff i % attn_period ==
attn_offset, every other layer is a Mamba mixer), and the
encoder-decoder family (``n_encoder_layers`` > 0: an encoder stack over
stubbed frame embeddings, cross-attention over its ``cross_kv_len``
memory rows).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Literal, Optional

AttnKind = Literal["full", "window"]


def pad_to(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int                 # per-expert FFN hidden dim
    n_shared_experts: int = 0
    d_shared: int = 0             # per-shared-expert hidden dim (0 -> d_expert)
    moe_period: int = 1           # MoE MLP every k-th layer (others dense d_ff)
    capacity_factor: float = 1.25
    router_noise: float = 0.0

    @property
    def d_shared_eff(self) -> int:
        return self.d_shared or self.d_expert


@dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_head_dim: int = 64
    qk_rope_head_dim: int = 32
    v_head_dim: int = 64

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim


@dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2


@dataclass(frozen=True)
class RWKVConfig:
    head_size: int = 64
    decay_lora: int = 64
    token_shift: bool = True


@dataclass(frozen=True)
class LayerSpec:
    """Structural plan for one transformer block."""
    mixer: str = "attn"                    # "attn", "mamba" or "rwkv6"
    attn: AttnKind = "full"
    mlp: str = "dense"                     # "dense" or "moe"


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
    mrope_sections: tuple[int, int, int] = (16, 24, 24)
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    sliding_window: Optional[int] = None   # window size for "window" layers
    window_pattern: int = 0                # >0: layer i is full iff i % pattern == pattern-1
    # --- family extensions ---
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    mamba: Optional[MambaConfig] = None
    rwkv: Optional[RWKVConfig] = None
    attn_period: int = 0                   # hybrid: layer i is attn iff i % attn_period == attn_offset
    attn_offset: int = 0
    # --- enc-dec / multimodal ---
    n_encoder_layers: int = 0              # >0 -> encoder-decoder
    frontend: Literal["none", "audio_stub", "vision_stub"] = "none"
    cross_kv_len: int = 1536               # stubbed encoder-memory length for decode shapes
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
        if self.mla is not None:
            return self.mla.qk_head_dim
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def v_head_dim_eff(self) -> int:
        if self.mla is not None:
            return self.mla.v_head_dim
        return self.head_dim_eff

    @property
    def padded_vocab(self) -> int:
        return pad_to(self.vocab_size, self.vocab_pad_mult)

    @property
    def is_encdec(self) -> bool:
        return self.n_encoder_layers > 0

    @property
    def is_subquadratic(self) -> bool:
        """True when long-context decode state does not grow with the
        sequence: the SSM / linear-attention families."""
        return self.family in ("ssm", "hybrid")

    def layer_plan(self) -> tuple[LayerSpec, ...]:
        specs = []
        for i in range(self.n_layers):
            if self.rwkv is not None:
                mixer = "rwkv6"
            elif self.mamba is not None and self.attn_period > 0:
                mixer = "attn" if i % self.attn_period == self.attn_offset \
                    else "mamba"
            elif self.mamba is not None:
                mixer = "mamba"
            else:
                mixer = "attn"
            if self.window_pattern > 0 and self.sliding_window:
                attn: AttnKind = ("full" if i % self.window_pattern
                                  == self.window_pattern - 1 else "window")
            elif self.sliding_window:
                attn = "window"
            else:
                attn = "full"
            mlp = "dense"
            if self.moe is not None and \
                    i % self.moe.moe_period == self.moe.moe_period - 1:
                mlp = "moe"
            specs.append(LayerSpec(mixer=mixer, attn=attn, mlp=mlp))
        return tuple(specs)

    def _attn_params(self) -> int:
        d, h, kv, hd = self.d_model, self.n_heads, self.n_kv_heads, self.head_dim_eff
        if self.mla is not None:
            m = self.mla
            p = d * m.q_lora_rank + m.q_lora_rank * h * m.qk_head_dim       # q down/up
            p += d * (m.kv_lora_rank + m.qk_rope_head_dim)                  # kv down + rope k
            p += m.kv_lora_rank * h * (m.qk_nope_head_dim + m.v_head_dim)   # kv up
            p += h * m.v_head_dim * d                                       # o proj
            return p
        return d * h * hd + 2 * d * kv * hd + h * self.v_head_dim_eff * d

    def _mamba_params(self) -> int:
        mc = self.mamba
        d_in = mc.expand * self.d_model
        p = self.d_model * 2 * d_in                      # in_proj (x, z)
        p += d_in * mc.d_conv                            # conv1d
        p += d_in * (mc.d_state * 2 + 1)                 # B, C, dt projections (selective)
        p += d_in * mc.d_state + d_in                    # A_log, D
        p += d_in * self.d_model                         # out_proj
        return p

    def _rwkv_params(self) -> int:
        d = self.d_model
        p = 5 * d * d                                    # r,k,v,g,o projections
        p += 2 * d * self.rwkv.decay_lora                # data-dependent decay lora
        p += 8 * d                                       # token-shift mixes, bonus u
        return p

    def _mlp_params(self, hidden: int) -> int:
        n_mat = 3 if self.gated_mlp else 2
        return n_mat * self.d_model * hidden

    def param_count(self, active_only: bool = False) -> int:
        """Parameter count as the reference's accounting makes it (embedding,
        head unless tied, norms, mixers and MLPs, an encoder stack and the
        decoder's cross-attention; no bias term, no encoder final norm);
        with ``active_only`` an MoE layer counts its top-k routed experts,
        not all of them."""
        total = self.padded_vocab * self.d_model
        if not self.tie_embeddings:
            total += self.padded_vocab * self.d_model
        total += self.d_model  # final norm
        mixer_params = {"attn": self._attn_params,
                        "mamba": self._mamba_params,
                        "rwkv6": self._rwkv_params}
        for spec in self.layer_plan():
            total += mixer_params[spec.mixer]()
            if spec.mlp == "moe":
                m = self.moe
                n_routed = m.top_k if active_only else m.n_experts
                total += n_routed * self._mlp_params(m.d_expert)
                total += m.n_shared_experts * self._mlp_params(m.d_shared_eff)
            else:
                total += self._mlp_params(self.d_ff)
            total += 2 * self.d_model  # 2 norms
        # encoder stack (attention + dense mlp, plus decoder cross-attn)
        if self.n_encoder_layers:
            per_enc = self._attn_params() + self._mlp_params(self.d_ff) \
                + 2 * self.d_model
            total += self.n_encoder_layers * per_enc
            total += self.n_layers * (self._attn_params() + self.d_model)
        return int(total)

    def kv_cache_bytes(self, batch: int, seq: int, bytes_per: int = 2) -> int:
        """Paper §1 cost model: K and V of every attention layer (a window
        layer holds at most its window; an MLA layer the latent and the
        rope key; an encoder-decoder's cross K/V over ``cross_kv_len``
        memory rows too); for RWKV the recurrent state and the two
        token-shift rows of every layer, and for a Mamba layer its
        [d_in, d_state] state and a d_conv-row conv window (the
        reference's count), whatever the sequence length."""
        if self.rwkv is not None:
            per_layer = self.n_heads * self.rwkv.head_size ** 2 + 2 * self.d_model
            return int(self.n_layers * batch * per_layer * bytes_per)
        total = 0
        for spec in self.layer_plan():
            if spec.mixer == "mamba":
                mc = self.mamba
                d_in = mc.expand * self.d_model
                total += batch * (d_in * mc.d_state + d_in * mc.d_conv)
                continue
            eff_seq = seq
            if spec.attn == "window" and self.sliding_window:
                eff_seq = min(seq, self.sliding_window)
            if self.mla is not None:
                width = self.mla.kv_lora_rank + self.mla.qk_rope_head_dim
            else:
                width = 2 * self.n_kv_heads * self.head_dim_eff
            total += batch * eff_seq * width
        if self.is_encdec:
            total += (self.n_layers * batch * self.cross_kv_len
                      * 2 * self.n_kv_heads * self.head_dim_eff)
        return int(total * bytes_per)

    def reduced(self, *, n_layers: int | None = None) -> "ModelConfig":
        """Smoke-test-scale config of the same structural family: 2 layers
        (``n_layers`` if given), and a hybrid at least ``attn_period``, so
        that it keeps an attention layer, as the reference's does."""
        nl = n_layers or 2
        if self.attn_period:
            nl = max(nl, self.attn_period)
        kv_ratio = max(1, self.n_heads // max(self.n_kv_heads, 1))
        n_heads = 4
        kw = {}
        if self.rope == "mrope":
            kw["mrope_sections"] = (2, 3, 3)       # sums to head_dim 16 // 2
        if self.moe is not None:
            kw["moe"] = replace(self.moe, n_experts=4,
                                top_k=min(self.moe.top_k, 2), d_expert=96,
                                d_shared=96,
                                n_shared_experts=min(self.moe.n_shared_experts, 1))
        if self.mla is not None:
            kw["mla"] = MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                                  qk_nope_head_dim=16, qk_rope_head_dim=8,
                                  v_head_dim=16)
        if self.mamba is not None:
            kw["mamba"] = replace(self.mamba, d_state=8, d_conv=4, expand=2)
        if self.rwkv is not None:
            kw["rwkv"] = replace(self.rwkv, head_size=16, decay_lora=8)
        return replace(
            self, name=self.name + "-reduced", n_layers=nl,
            d_model=64, n_heads=n_heads,
            n_kv_heads=max(1, n_heads // min(kv_ratio, n_heads)),
            head_dim=0 if self.mla is not None else 16, d_ff=128, vocab_size=512, vocab_pad_mult=64,
            n_encoder_layers=2 if self.is_encdec else 0,
            cross_kv_len=16 if self.is_encdec else self.cross_kv_len,
            sliding_window=8 if self.sliding_window else None, **kw)


def group_period(cfg: ModelConfig) -> int:
    """The smallest block of layers that repeats the layer plan: the lcm of
    the hybrid attention period, the MoE period and the local/global
    window pattern (the reference's ``group_period``,
    ``repro/models/transformer.py``).  A depth cut keeps whole periods;
    a config that is not a whole number of them raises, as the
    reference asserts."""
    p = 1
    if cfg.attn_period:
        p = math.lcm(p, cfg.attn_period)
    if cfg.moe is not None:
        p = math.lcm(p, cfg.moe.moe_period)
    if cfg.window_pattern:
        p = math.lcm(p, cfg.window_pattern)
    if cfg.n_layers % p:
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers are not a whole "
                         f"number of {p}-layer periods")
    return p


StepKind = Literal["train", "prefill", "decode"]


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: StepKind
    needs_subquadratic: bool = False


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode", needs_subquadratic=True),
}


def cell_is_runnable(model: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether (arch × shape) is a defined cell, and why not when skipped
    (every arch of the port has a decoder, so only the long-context shape
    can be skipped)."""
    if shape.needs_subquadratic and not model.is_subquadratic:
        return False, "long_500k skipped: pure full-attention arch"
    return True, ""


@dataclass(frozen=True)
class HWSpec:
    name: str
    peak_flops: float          # per-chip dense bf16 FLOP/s (tensor cores)
    peak_flops_fp32: float     # per-chip fp32 FLOP/s outside the tensor cores
    peak_flops_tf32: float     # per-chip dense TF32 FLOP/s (tensor cores)
    hbm_bw: float              # bytes/s
    hbm_bytes: float
    ici_bw: float              # bytes/s a chip, within a link domain
    dcn_bw: float              # bytes/s a chip, between link domains
    link_domain: int           # chips that one fast-link domain joins


# NVIDIA H100 SXM data sheet: 989 TFLOP/s dense bf16, 495 TF32, 67 TFLOP/s
# fp32 outside the tensor cores, 3.35 TB/s HBM3, 80 GiB; NVLink 4 at 450
# GB/s a direction among the 8 GPUs of an HGX H100 board; 400 Gb/s NDR
# InfiniBand a GPU (50e9 B/s) between boards.  Data-sheet values, not
# measurements.
H100 = HWSpec("h100-sxm", peak_flops=989e12, peak_flops_fp32=67e12,
              peak_flops_tf32=495e12, hbm_bw=3.35e12, hbm_bytes=80 * 2**30,
              ici_bw=450e9, dcn_bw=50e9, link_domain=8)
