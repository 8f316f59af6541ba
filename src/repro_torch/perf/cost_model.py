"""Analytic cost model: FLOPs / HBM bytes / collective bytes per step for an
(arch × shape × parallelism plan).  The HELR-mesh deployer scores its
candidate plans with it.

Own copy of ``repro/perf/cost_model.py`` with the same formulas, trimmed to
the families the port serves (dense attention, with windows and MLA, MoE
MLPs, Mamba, RWKV-6, and the encoder-decoder's encoder stack and
cross-attention).  Of the reference's plan options the port keeps the two
its hillclimb sets (``launch.hillclimb``): the absorbed MLA decode and a
quantized KV cache; those that no port plan sets (sequence-sharded
attention, unsharded residuals, a causal discount) are left out.  The
default hardware is the port's ``H100``.

Conventions: bf16 params/activations/KV (2 bytes), fp32 accumulation;
residuals sharded over the model axis between blocks; causal attention
counted at half the full s².  Each collective is priced at the link class
its group crosses: ``ici_bw`` within ``hw.link_domain`` chips, ``dcn_bw``
beyond (the reference prices every collective at its ICI rate).
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.configs.base import H100, HWSpec, ModelConfig, ShapeConfig


@dataclass
class ParallelismDesc:
    """How a step is distributed — the analytic mirror of a ShardingPlan."""
    n_chips: int = 1
    tp: int = 1                 # tensor parallel degree (model axis)
    dp: int = 1                 # data parallel degree (incl. pod axis)
    fsdp: bool = False          # params/opt-state sharded over dp
    ep: int = 1                 # expert parallel degree
    seq_shard_decode: int = 1   # flash-decoding shards
    remat: bool = True
    microbatches: int = 1       # gradient accumulation (live activations / n)
    optimizer: str = "adafactor"   # "adamw" | "adafactor"
    kv_bytes_per: int = 2          # quantized KV -> 1
    mla_absorbed: bool = False     # matmul-absorbed MLA decode


@dataclass
class CostTerms:
    flops: float = 0.0              # per chip
    hbm_bytes: float = 0.0          # per chip
    model_flops: float = 0.0        # global 6ND reference
    weight_bytes_chip: float = 0.0
    kv_bytes_chip: float = 0.0
    act_bytes_chip: float = 0.0      # live activation *storage*
    opt_bytes_chip: float = 0.0
    notes: dict = field(default_factory=dict)
    # (group size, bytes per chip) of each collective, in the order added
    coll_parts: list[tuple[int, float]] = field(default_factory=list)

    @property
    def coll_bytes(self) -> float:
        """Per-chip collective bytes, all link classes together."""
        return sum((b for _, b in self.coll_parts), 0.0)

    @property
    def hbm_resident(self) -> float:
        """Per-chip bytes that must fit simultaneously."""
        return (self.weight_bytes_chip + self.kv_bytes_chip
                + self.act_bytes_chip + self.opt_bytes_chip)

    def times(self, hw: HWSpec = H100):
        """Roofline terms in seconds (per chip); a collective whose group
        spans more than ``hw.link_domain`` chips goes at ``hw.dcn_bw``."""
        near = far = 0.0
        for group, nbytes in self.coll_parts:
            if group <= hw.link_domain:
                near += nbytes
            else:
                far += nbytes
        return {
            "compute_s": self.flops / hw.peak_flops,
            "memory_s": self.hbm_bytes / hw.hbm_bw,
            "collective_s": near / hw.ici_bw + far / hw.dcn_bw,
        }

    def bottleneck(self, hw: HWSpec = H100) -> str:
        t = self.times(hw)
        return max(t, key=t.get).replace("_s", "")


def _attn_layer_flops(cfg: ModelConfig, b: int, s_q: int, s_kv: int,
                      causal: float) -> float:
    """Attention score+value FLOPs for one layer (projections counted via
    params elsewhere)."""
    h = cfg.n_heads
    d_qk = cfg.head_dim_eff
    d_v = cfg.v_head_dim_eff
    return 2.0 * b * s_q * s_kv * h * (d_qk + d_v) * causal


def _layer_param_counts(cfg: ModelConfig) -> dict:
    """Parameters a layer's part holds, by kind: the mixers, the dense MLP,
    an MoE layer's active (top-k) routed experts and its shared ones."""
    m = cfg.moe
    return {
        "attn": cfg._attn_params(),
        "mamba": cfg._mamba_params() if cfg.mamba else 0,
        "rwkv6": cfg._rwkv_params() if cfg.rwkv else 0,
        "mlp": cfg._mlp_params(cfg.d_ff),
        "moe_routed_active": m.top_k * cfg._mlp_params(m.d_expert) if m else 0,
        "moe_shared": m.n_shared_experts * cfg._mlp_params(m.d_shared_eff)
        if m else 0,
    }


def _matmul_param_flops(cfg: ModelConfig, tokens: float) -> float:
    """2 * active params * tokens for all projections/MLPs and the LM head
    (global); an MoE layer's routed experts at the capacity factor."""
    pc = _layer_param_counts(cfg)
    total = 0.0
    for spec in cfg.layer_plan():
        total += pc[spec.mixer]
        if spec.mlp == "moe":
            total += pc["moe_routed_active"] * cfg.moe.capacity_factor \
                + pc["moe_shared"]
        else:
            total += pc["mlp"]
    if cfg.is_encdec:
        total += cfg.n_encoder_layers * (pc["attn"] + pc["mlp"])
        total += cfg.n_layers * pc["attn"]          # cross attention
    total += cfg.d_model * cfg.padded_vocab
    return 2.0 * total * tokens


def _scan_state_flops(cfg: ModelConfig, b: int, s: int) -> float:
    """Mamba / RWKV state-evolution FLOPs (beyond the projections)."""
    total = 0.0
    for spec in cfg.layer_plan():
        if spec.mixer == "mamba":
            mc = cfg.mamba
            d_in = mc.expand * cfg.d_model
            total += 10.0 * b * s * d_in * mc.d_state   # discretize+scan+C·h
        elif spec.mixer == "rwkv6":
            rc = cfg.rwkv
            h = cfg.d_model // rc.head_size
            chunk = 32.0
            total += b * s * h * (2 * chunk * rc.head_size   # intra-chunk A
                                  + 4 * rc.head_size ** 2)   # state update+out
    return total


def _add_attn_flops(fwd: float, cfg: ModelConfig, b: int, s: int) -> float:
    """``fwd`` plus the score+value FLOPs of every attention layer over a
    whole s-token sequence (train and prefill), added layer by layer as the
    reference adds them: half the square for full causal layers."""
    for spec in cfg.layer_plan():
        if spec.mixer != "attn":
            continue
        s_kv = min(s, cfg.sliding_window) if spec.attn == "window" else s
        fwd += _attn_layer_flops(cfg, b, s, s_kv,
                                 0.5 if spec.attn != "window" else 1.0)
    return fwd


def weight_bytes(cfg: ModelConfig, desc: ParallelismDesc) -> float:
    """Per-chip parameter bytes under the plan.  Routed expert banks shard
    over ep × tp; the dense remainder over tp (× dp when FSDP)."""
    total = cfg.param_count() * 2.0
    dense_shards = desc.tp * (desc.dp if desc.fsdp else 1)
    if desc.ep > 1 and cfg.moe is not None:
        expert = sum(cfg.moe.n_experts * cfg._mlp_params(cfg.moe.d_expert)
                     for sp in cfg.layer_plan() if sp.mlp == "moe") * 2.0
        dense = total - expert
        return dense / max(dense_shards, 1) + expert / (desc.ep * desc.tp)
    return total / max(dense_shards, 1)


def optimizer_bytes(cfg: ModelConfig, desc: ParallelismDesc) -> float:
    per_param = 12.0 if desc.optimizer == "adamw" else 4.5  # fp32 m+v+master | bf16 master + factored v
    return weight_bytes(cfg, desc) / 2.0 * per_param


def step_cost(cfg: ModelConfig, shape: ShapeConfig,
              desc: ParallelismDesc) -> CostTerms:
    b, s = shape.global_batch, shape.seq_len
    ct = CostTerms()
    d = cfg.d_model

    if shape.kind == "train":
        tokens = float(b) * s
        fwd = _add_attn_flops(_matmul_param_flops(cfg, tokens)
                              + _scan_state_flops(cfg, b, s), cfg, b, s)
        if cfg.is_encdec:
            fwd += cfg.n_encoder_layers * _attn_layer_flops(cfg, b, s, s, 1.0)
            fwd += cfg.n_layers * _attn_layer_flops(cfg, b, s,
                                                    cfg.cross_kv_len, 1.0)
        mult = 3.0 + (1.0 if desc.remat else 0.0)
        ct.model_flops = 6.0 * cfg.param_count(active_only=True) * tokens
        total_flops = fwd * mult
        ct.flops = total_flops / desc.n_chips

        ct.weight_bytes_chip = weight_bytes(cfg, desc)
        ct.opt_bytes_chip = optimizer_bytes(cfg, desc)
        tokens_local = tokens / max(desc.dp, 1)
        # live activation *storage*: with remat only block-boundary residuals
        # persist (2 per layer), divided by microbatching and by tp (the
        # residuals are sharded over the model axis)
        resid_shard = desc.tp
        stored_per_layer = 2.0 if desc.remat else 14.0
        ct.act_bytes_chip = stored_per_layer * (tokens_local / desc.microbatches) \
            * d * 2.0 * cfg.n_layers / resid_shard
        # HBM *traffic*: weights fwd+bwd+update, full activation stream
        # (compute traffic, not storage) written+read once each
        act_traffic = 14.0 * tokens_local * d * 2.0 * cfg.n_layers / resid_shard
        ct.hbm_bytes = 3.0 * ct.weight_bytes_chip + 2.0 * act_traffic \
            + 2.0 * ct.opt_bytes_chip
        # collectives: TP 4 allreduce/layer of local activation slab,
        # DP grad reduce-scatter+allgather, FSDP weight allgather, the EP
        # all-to-all of each MoE layer's dispatch and combine
        coll = ct.coll_parts
        if desc.tp > 1:
            ring = 2.0 * (desc.tp - 1) / desc.tp
            coll.append((desc.tp, 4.0 * cfg.n_layers * tokens_local * d * 2.0 * ring))
        if desc.dp > 1:
            grad_bytes = cfg.param_count() * 2.0 / desc.tp
            coll.append((desc.dp, 2.0 * grad_bytes * (desc.dp - 1) / desc.dp))
            if desc.fsdp:  # extra allgather
                coll.append((desc.dp, grad_bytes * (desc.dp - 1) / desc.dp))
        if desc.ep > 1 and cfg.moe is not None:
            n_moe = sum(1 for sp in cfg.layer_plan() if sp.mlp == "moe")
            coll.append((desc.ep, 2.0 * tokens_local * d * 2.0
                         * cfg.moe.top_k * n_moe))
        ct.kv_bytes_chip = 0.0
        return ct

    if shape.kind == "prefill":
        tokens = float(b) * s
        fwd = _add_attn_flops(_matmul_param_flops(cfg, tokens)
                              + _scan_state_flops(cfg, b, s), cfg, b, s)
        if cfg.is_encdec:   # the encoder; the reference prices no cross term
            fwd += cfg.n_encoder_layers * _attn_layer_flops(cfg, b, s, s, 1.0)
        ct.model_flops = 2.0 * cfg.param_count(active_only=True) * tokens
        ct.flops = fwd / desc.n_chips
        ct.weight_bytes_chip = weight_bytes(cfg, desc)
        kv_total = cfg.kv_cache_bytes(b, s, desc.kv_bytes_per)
        ct.kv_bytes_chip = kv_total / desc.n_chips
        tokens_local = tokens / max(desc.dp, 1)
        resid_shard = desc.tp
        # storage: a few residual slabs of the current layer working set
        ct.act_bytes_chip = 6.0 * tokens_local * d * 2.0 / resid_shard
        # traffic: full activation stream through every layer
        act_traffic = 8.0 * tokens_local * d * 2.0 * cfg.n_layers / resid_shard
        ct.hbm_bytes = ct.weight_bytes_chip + act_traffic + ct.kv_bytes_chip
        if desc.tp > 1:
            ring = 2.0 * (desc.tp - 1) / desc.tp
            ct.coll_parts.append(
                (desc.tp, 2.0 * cfg.n_layers * tokens_local * d * 2.0 * ring))
        return ct

    # decode: one token per sequence against a seq-long cache
    tokens = float(b)
    fwd = _matmul_param_flops(cfg, tokens) + _scan_state_flops(cfg, b, 1)
    for spec in cfg.layer_plan():
        if spec.mixer != "attn":
            continue
        s_kv = min(s, cfg.sliding_window) if spec.attn == "window" else s
        fwd += _attn_layer_flops(cfg, b, 1, s_kv, 1.0)
    if cfg.is_encdec:
        fwd += cfg.n_layers * _attn_layer_flops(cfg, b, 1, cfg.cross_kv_len, 1.0)
    extra_hbm = 0.0
    if cfg.mla is not None:
        m = cfg.mla
        if desc.mla_absorbed:
            # latent-space attention: q/out absorption + latent scores/values
            fwd += cfg.n_layers * 2.0 * b * cfg.n_heads * (
                m.qk_nope_head_dim * m.kv_lora_rank
                + s * (2 * m.kv_lora_rank + m.qk_rope_head_dim)
                + m.kv_lora_rank * m.v_head_dim)
        else:
            # latent -> K,V expansion each step: 2*S*r*H*(dn+dv) per layer,
            # and the expanded K/V are written+read through HBM
            fwd += cfg.n_layers * 2.0 * b * s * m.kv_lora_rank * \
                cfg.n_heads * (m.qk_nope_head_dim + m.v_head_dim)
            extra_hbm = cfg.n_layers * 2.0 * b * s * cfg.n_heads * \
                (m.qk_head_dim + m.v_head_dim) * 2.0 / desc.n_chips
    ct.model_flops = 2.0 * cfg.param_count(active_only=True) * tokens
    ct.flops = fwd / desc.n_chips
    ct.weight_bytes_chip = weight_bytes(cfg, desc)
    kv_total = cfg.kv_cache_bytes(b, s, desc.kv_bytes_per)
    ct.kv_bytes_chip = kv_total / desc.n_chips
    # decode reads all local weights + all local KV each step
    ct.hbm_bytes = ct.weight_bytes_chip + ct.kv_bytes_chip \
        + 4.0 * (tokens / max(desc.dp, 1)) * d * 2.0 * cfg.n_layers \
        + extra_hbm
    coll = ct.coll_parts
    if desc.tp > 1:
        ring = 2.0 * (desc.tp - 1) / desc.tp
        b_local = b / max(desc.dp, 1)
        coll.append((desc.tp, 2.0 * cfg.n_layers * b_local * d * 2.0 * ring))
    if desc.seq_shard_decode > 1:
        # flash-decoding combine: psum of [b_local, H, dv] + stats per layer
        b_local = b / max(desc.dp, 1)
        n_attn = sum(1 for sp in cfg.layer_plan() if sp.mixer == "attn")
        coll.append((desc.seq_shard_decode,
                     n_attn * b_local * cfg.n_heads * (cfg.v_head_dim_eff + 2) * 4.0
                     * 2.0 * (desc.seq_shard_decode - 1) / desc.seq_shard_decode))
    return ct
