"""Synthetic serving workload (Alpaca-like): Poisson arrivals, lognormal
input/output lengths, uniform-random SLOs in [1, 350] s (paper §5.1).

Own copy of ``repro/data/workload.py`` (numpy only, so a seed gives the same
request stream as the reference): the Alpaca-like mix, the shared-prefix
mix, and the mixed-model, tier-tagged trace of the simulated fleet.

Prompts carry a learnable verbosity signal: tokens from the low "marker"
range correlate with long answers — standing in for the semantic signal the
paper's fine-tuned ChatGLM3 predictor picks up from real questions.  The
length predictor must *learn* this (it is not told the rule).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.types import Request


@dataclass
class WorkloadConfig:
    n_requests: int = 256
    arrival_rate: float = 8.0          # req/s (Poisson)
    slo_lo: float = 1.0                # paper: 1 .. 350 s
    slo_hi: float = 350.0
    vocab: int = 1024
    marker_tokens: int = 32            # tokens [0, 32) signal verbosity
    input_mean: float = 4.5            # lognormal of input length
    input_sigma: float = 0.6
    output_base: float = 32.0
    output_max: int = 1024
    length_noise: float = 0.1          # lognormal sigma on top of the signal
    marker_frac: float = 0.35          # max fraction of marker tokens
    seed: int = 0
    # --- arrival process (cluster autoscaler studies) ---
    arrival_pattern: str = "poisson"   # "poisson" | "bursty" | "diurnal"
    burst_factor: float = 5.0          # burst-state rate multiplier (bursty)
    burst_mean_s: float = 4.0          # mean burst duration (s)
    quiet_mean_s: float = 12.0         # mean quiet duration (s)
    quiet_factor: float = 0.25         # quiet-state rate multiplier (bursty)
    diurnal_period: float = 60.0       # one "day" of the sinusoid (s)
    diurnal_amplitude: float = 0.8     # 0..1 swing around arrival_rate


def gen_arrivals(rng: np.random.Generator, n: int, rate: float,
                 pattern: str = "poisson", *,
                 burst_factor: float = 5.0, burst_mean_s: float = 4.0,
                 quiet_mean_s: float = 12.0, quiet_factor: float = 0.25,
                 diurnal_period: float = 60.0,
                 diurnal_amplitude: float = 0.8) -> np.ndarray:
    """Arrival timestamps for ``n`` requests under one of three processes:

    * ``poisson``  — homogeneous (the paper's §5.1 load);
    * ``bursty``   — Markov-modulated Poisson: exponential quiet/burst
      sojourns at ``quiet_factor``/``burst_factor`` times the base rate —
      the flash-crowd shape an autoscaler must absorb;
    * ``diurnal``  — inhomogeneous Poisson via thinning, rate(t) =
      rate·(1 + amplitude·sin(2πt/period)) — the day/night cycle
      forecast-driven scaling (SageServe, PAPERS.md) exploits.
    """
    if pattern == "poisson":
        return np.cumsum(rng.exponential(1.0 / rate, n))
    if pattern == "bursty":
        out: list[float] = []
        t, burst = 0.0, False
        while len(out) < n:
            span = rng.exponential(burst_mean_s if burst else quiet_mean_s)
            r = rate * (burst_factor if burst else quiet_factor)
            tt = t + rng.exponential(1.0 / r)
            while tt < t + span and len(out) < n:
                out.append(tt)
                tt += rng.exponential(1.0 / r)
            t += span
            burst = not burst
        return np.asarray(out)
    if pattern == "diurnal":
        peak = rate * (1.0 + diurnal_amplitude)
        out = []
        t = 0.0
        while len(out) < n:
            t += rng.exponential(1.0 / peak)
            lam = rate * (1.0 + diurnal_amplitude
                          * np.sin(2.0 * np.pi * t / diurnal_period))
            if rng.uniform() * peak < lam:
                out.append(t)
        return np.asarray(out)
    raise ValueError(f"unknown arrival pattern: {pattern!r}")


def _cfg_arrivals(rng: np.random.Generator, cfg) -> np.ndarray:
    return gen_arrivals(
        rng, cfg.n_requests, cfg.arrival_rate, cfg.arrival_pattern,
        burst_factor=cfg.burst_factor, burst_mean_s=cfg.burst_mean_s,
        quiet_mean_s=cfg.quiet_mean_s, quiet_factor=cfg.quiet_factor,
        diurnal_period=cfg.diurnal_period,
        diurnal_amplitude=cfg.diurnal_amplitude)


def gen_requests(cfg: WorkloadConfig) -> list[Request]:
    rng = np.random.default_rng(cfg.seed)
    arrivals = _cfg_arrivals(rng, cfg)
    reqs = []
    for i in range(cfg.n_requests):
        in_len = int(np.clip(rng.lognormal(cfg.input_mean, cfg.input_sigma), 8, 512))
        verbosity = rng.uniform(0.0, 1.0)
        # marker *fraction* tracks verbosity -> mean-pooled embeddings carry it
        n_markers = int(round(verbosity * cfg.marker_frac * in_len))
        toks = rng.integers(cfg.marker_tokens, cfg.vocab, size=in_len)
        marker_pos = rng.choice(in_len, size=n_markers, replace=False)
        toks[marker_pos] = rng.integers(0, cfg.marker_tokens, size=n_markers)
        out_len = int(np.clip(
            cfg.output_base * np.exp(2.5 * verbosity)
            * rng.lognormal(0.0, cfg.length_noise),
            1, cfg.output_max))
        reqs.append(Request(
            rid=i, tokens=toks.tolist(), input_len=in_len,
            slo=float(rng.uniform(cfg.slo_lo, cfg.slo_hi)),
            arrival=float(arrivals[i]), true_output_len=out_len))
    return reqs


@dataclass
class SharedPrefixConfig:
    """Shared-prefix / multi-turn serving scenario (beyond-paper; the
    template-heavy workload mix SageServe's cloud traces show and the
    'Taming the Titans' survey names prefix caching for — PAPERS.md).

    ``turns == 1``: every request is ``template + unique suffix`` — the
    system-prompt / few-shot pattern, replayable through PagedEngine's
    prefix cache as-is.  ``turns > 1``: conversations whose turn-k prompt
    is the previous prompt + a synthetic assistant answer + new user text —
    the prompt-*growth* pattern for scheduler/simulator studies (a live
    engine's hits additionally depend on the tokens it actually generated).
    """
    n_requests: int = 64
    n_templates: int = 4               # distinct system prompts
    prefix_len: int = 48               # template length (tokens)
    suffix_mean: float = 3.0           # lognormal of the unique-suffix length
    suffix_sigma: float = 0.5
    turns: int = 1
    answer_len: int = 24               # synthetic assistant tokens per turn
    arrival_rate: float = 8.0
    slo_lo: float = 1.0
    slo_hi: float = 350.0
    vocab: int = 1024
    output_base: float = 32.0
    output_max: int = 1024
    seed: int = 0
    # --- arrival process (same knobs as WorkloadConfig) ---
    arrival_pattern: str = "poisson"
    burst_factor: float = 5.0
    burst_mean_s: float = 4.0
    quiet_mean_s: float = 12.0
    quiet_factor: float = 0.25
    diurnal_period: float = 60.0
    diurnal_amplitude: float = 0.8


def gen_shared_prefix_requests(cfg: SharedPrefixConfig) -> list[Request]:
    rng = np.random.default_rng(cfg.seed)
    templates = [rng.integers(0, cfg.vocab, cfg.prefix_len).tolist()
                 for _ in range(cfg.n_templates)]
    arrivals = _cfg_arrivals(rng, cfg)
    # round-robin conversations over templates; each conversation's context
    # grows turn over turn
    n_convs = max(1, cfg.n_requests // cfg.turns)
    contexts = [list(templates[c % cfg.n_templates]) for c in range(n_convs)]
    reqs = []
    for i in range(cfg.n_requests):
        conv = i % n_convs
        suffix_len = int(np.clip(
            rng.lognormal(cfg.suffix_mean, cfg.suffix_sigma), 4, 256))
        prompt = contexts[conv] + rng.integers(0, cfg.vocab,
                                               suffix_len).tolist()
        out_len = int(np.clip(rng.lognormal(np.log(cfg.output_base), 0.5),
                              1, cfg.output_max))
        reqs.append(Request(
            rid=i, tokens=prompt, input_len=len(prompt),
            slo=float(rng.uniform(cfg.slo_lo, cfg.slo_hi)),
            arrival=float(arrivals[i]), true_output_len=out_len))
        if cfg.turns > 1:
            contexts[conv] = prompt + rng.integers(
                0, cfg.vocab, cfg.answer_len).tolist()
    return reqs


@dataclass
class MixedWorkloadConfig:
    """Mixed-model MLaaS trace (UELLM's actual setting; SageServe traces):
    one merged arrival stream whose requests are tagged with a ``model``
    (per-model traffic mix) and an SLO ``tier`` (per-model tier skew).

    ``models`` is ``((arch_id, traffic_weight), ...)``; ``tiers`` is
    ``((name, slo_lo, slo_hi), ...)``.  ``tier_weights`` optionally skews
    the tier draw per model (``{arch_id: (w_tier0, w_tier1, ...)}``) —
    e.g. a small chat model mostly "interactive", a large summarizer
    mostly "batch".  Request shapes reuse the Alpaca-like marker scheme of
    ``WorkloadConfig`` so length predictors keep working unchanged.
    """
    models: tuple = (("chatglm2-6b", 0.5), ("qwen2-1.5b", 0.5))
    tiers: tuple = (("interactive", 2.0, 12.0), ("batch", 30.0, 120.0))
    tier_weights: dict = field(default_factory=dict)
    n_requests: int = 256
    arrival_rate: float = 8.0
    t0: float = 0.0                    # arrival offset (phase-shifted mixes)
    vocab: int = 1024
    marker_tokens: int = 32
    input_mean: float = 4.5
    input_sigma: float = 0.6
    output_base: float = 32.0
    output_max: int = 1024
    length_noise: float = 0.1
    marker_frac: float = 0.35
    seed: int = 0
    # --- arrival process (same knobs as WorkloadConfig) ---
    arrival_pattern: str = "poisson"
    burst_factor: float = 5.0
    burst_mean_s: float = 4.0
    quiet_mean_s: float = 12.0
    quiet_factor: float = 0.25
    diurnal_period: float = 60.0
    diurnal_amplitude: float = 0.8


def gen_mixed_requests(cfg: MixedWorkloadConfig) -> list[Request]:
    """Requests tagged (model, tier) with tier-skewed SLOs, merged arrivals."""
    if not cfg.models:
        raise ValueError("MixedWorkloadConfig.models must be non-empty")
    if not cfg.tiers:
        raise ValueError("MixedWorkloadConfig.tiers must be non-empty")
    rng = np.random.default_rng(cfg.seed)
    arrivals = _cfg_arrivals(rng, cfg)
    names = [m for m, _ in cfg.models]
    mw = np.asarray([w for _, w in cfg.models], float)
    mw = mw / mw.sum()
    tier_w = {}
    for m in names:
        w = np.asarray(cfg.tier_weights.get(m, [1.0] * len(cfg.tiers)), float)
        if len(w) != len(cfg.tiers):
            raise ValueError(f"tier_weights[{m!r}] needs {len(cfg.tiers)} "
                             f"entries, got {len(w)}")
        tier_w[m] = w / w.sum()
    reqs = []
    for i in range(cfg.n_requests):
        model = names[int(rng.choice(len(names), p=mw))]
        tname, slo_lo, slo_hi = cfg.tiers[int(rng.choice(len(cfg.tiers),
                                                         p=tier_w[model]))]
        in_len = int(np.clip(rng.lognormal(cfg.input_mean, cfg.input_sigma),
                             8, 512))
        verbosity = rng.uniform(0.0, 1.0)
        n_markers = int(round(verbosity * cfg.marker_frac * in_len))
        toks = rng.integers(cfg.marker_tokens, cfg.vocab, size=in_len)
        marker_pos = rng.choice(in_len, size=n_markers, replace=False)
        toks[marker_pos] = rng.integers(0, cfg.marker_tokens, size=n_markers)
        out_len = int(np.clip(
            cfg.output_base * np.exp(2.5 * verbosity)
            * rng.lognormal(0.0, cfg.length_noise),
            1, cfg.output_max))
        reqs.append(Request(
            rid=i, tokens=toks.tolist(), input_len=in_len,
            slo=float(rng.uniform(slo_lo, slo_hi)),
            arrival=float(cfg.t0 + arrivals[i]), true_output_len=out_len,
            model=model, tier=tname))
    return reqs


def merge_request_streams(*streams: list[Request]) -> list[Request]:
    """Interleave tagged streams by arrival time and re-number rids — the
    composition primitive for phase-shifted multi-model traces."""
    merged = sorted((r for s in streams for r in s), key=lambda r: r.arrival)
    for i, r in enumerate(merged):
        r.rid = i
    return merged


def train_pairs(cfg: WorkloadConfig, n: int, seed: int = 1):
    """(tokens_padded [n, max_len], lengths [n]) for predictor training."""
    wcfg = WorkloadConfig(**{**cfg.__dict__, "n_requests": n, "seed": seed})
    reqs = gen_requests(wcfg)
    max_len = max(r.input_len for r in reqs)
    toks = np.zeros((n, max_len), np.int32)
    for i, r in enumerate(reqs):
        toks[i, :r.input_len] = r.tokens
    lens = np.array([r.true_output_len for r in reqs], np.int32)
    return toks, lens
