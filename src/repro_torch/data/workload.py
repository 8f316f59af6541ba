"""Synthetic serving workload (Alpaca-like): Poisson arrivals, lognormal
input/output lengths, uniform-random SLOs in [1, 350] s (paper §5.1).

Own copy of ``repro/data/workload.py`` (numpy only, so a seed gives the same
request stream as the reference), trimmed to the single-model workloads the
serve paths draw: the Alpaca-like mix and the shared-prefix mix; the
mixed-model generator comes with the cluster slice.

Prompts carry a learnable verbosity signal: tokens from the low "marker"
range correlate with long answers.
"""
from __future__ import annotations

from dataclasses import dataclass

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
    arrival_pattern: str = "poisson"   # "poisson" | "bursty" | "diurnal"
    burst_factor: float = 5.0
    burst_mean_s: float = 4.0
    quiet_mean_s: float = 12.0
    quiet_factor: float = 0.25
    diurnal_period: float = 60.0
    diurnal_amplitude: float = 0.8


def gen_arrivals(rng: np.random.Generator, cfg) -> np.ndarray:
    """Arrival timestamps: homogeneous Poisson, Markov-modulated bursts, or a
    diurnal sinusoid by thinning.  ``cfg`` is a WorkloadConfig or a
    SharedPrefixConfig (the same arrival fields)."""
    n, rate = cfg.n_requests, cfg.arrival_rate
    if cfg.arrival_pattern == "poisson":
        return np.cumsum(rng.exponential(1.0 / rate, n))
    if cfg.arrival_pattern == "bursty":
        out: list[float] = []
        t, burst = 0.0, False
        while len(out) < n:
            span = rng.exponential(cfg.burst_mean_s if burst
                                   else cfg.quiet_mean_s)
            r = rate * (cfg.burst_factor if burst else cfg.quiet_factor)
            tt = t + rng.exponential(1.0 / r)
            while tt < t + span and len(out) < n:
                out.append(tt)
                tt += rng.exponential(1.0 / r)
            t += span
            burst = not burst
        return np.asarray(out)
    if cfg.arrival_pattern == "diurnal":
        peak = rate * (1.0 + cfg.diurnal_amplitude)
        out = []
        t = 0.0
        while len(out) < n:
            t += rng.exponential(1.0 / peak)
            lam = rate * (1.0 + cfg.diurnal_amplitude
                          * np.sin(2.0 * np.pi * t / cfg.diurnal_period))
            if rng.uniform() * peak < lam:
                out.append(t)
        return np.asarray(out)
    raise ValueError(f"unknown arrival pattern: {cfg.arrival_pattern!r}")


def gen_requests(cfg: WorkloadConfig) -> list[Request]:
    rng = np.random.default_rng(cfg.seed)
    arrivals = gen_arrivals(rng, cfg)
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
    """Shared-prefix / multi-turn serving scenario (beyond-paper): every
    request is ``template + unique suffix`` (``turns == 1``, the
    system-prompt / few-shot pattern the prefix cache serves), or
    conversations whose turn-k prompt is the previous prompt + a synthetic
    answer + new user text (``turns > 1``)."""
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
    arrivals = gen_arrivals(rng, cfg)
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
