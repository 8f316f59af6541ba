"""Core serving types shared by the profiler, scheduler, monitor, engine,
deployer and simulator.

Own copy of ``repro/core/types.py``."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


@dataclass
class Request:
    """One inference query."""
    rid: int
    tokens: list[int]                  # prompt token ids
    input_len: int
    slo: float                          # seconds: complete answer deadline (paper §5.1)
    arrival: float                      # seconds since epoch start
    true_output_len: int                # workload ground truth (hidden from scheduler)
    # --- filled by the resource profiler ---
    predicted_output_len: Optional[int] = None
    predicted_bucket: Optional[int] = None
    kv_bytes_estimate: float = 0.0
    # --- bookkeeping ---
    start_time: Optional[float] = None
    finish_time: Optional[float] = None
    first_token_time: Optional[float] = None   # TTFT numerator (run clock)
    generated: int = 0
    #   tokens already produced before (re-)dispatch: the recompute prefix a
    #   retry replays after its replica crashed mid-decode (cluster fault
    #   mode), so retried outputs stay token-identical to an unfailed run
    # per-phase latency attribution (obs.trace.LatencyBreakdown), attached
    # by the serving path at finish so SLO violations decompose by phase
    breakdown: Optional[object] = None
    # --- heterogeneous fleet (empty = legacy single-model run) ---
    model: str = ""                     # arch id the request must be served by
    tier: str = ""                      # SLO tier label ("interactive", "batch", ...)

    @property
    def latency(self) -> Optional[float]:
        if self.finish_time is None:
            return None
        return self.finish_time - self.arrival

    @property
    def ttft(self) -> Optional[float]:
        """Arrival -> first emitted token (None until one is emitted)."""
        if self.first_token_time is None:
            return None
        return max(0.0, self.first_token_time - self.arrival)

    @property
    def slo_met(self) -> Optional[bool]:
        lat = self.latency
        return None if lat is None else (lat <= self.slo)

    @property
    def sched_output_len(self) -> int:
        """Length the scheduler plans with (prediction, else a conservative cap)."""
        return self.predicted_output_len if self.predicted_output_len else 512


@dataclass
class Batch:
    """A scheduled batch: requests padded to common input length; the decode
    phase runs until max output length (paper §4.2 cost model)."""
    requests: list[Request] = field(default_factory=list)

    def __len__(self):
        return len(self.requests)

    @property
    def padded_input(self) -> int:
        return max((r.input_len for r in self.requests), default=0)

    @property
    def padded_output(self) -> int:
        return max((r.sched_output_len for r in self.requests), default=0)

    @property
    def true_padded_output(self) -> int:
        return max((r.true_output_len for r in self.requests), default=0)

    @property
    def total_tokens(self) -> int:
        """b × (padded in+out): the paper's Fig.3 token-cost metric."""
        return len(self.requests) * (self.padded_input + self.padded_output)

    @property
    def padding_waste(self) -> int:
        """Tokens generated/stored beyond what each request actually needs."""
        return self.total_tokens - sum(r.input_len + r.sched_output_len
                                       for r in self.requests)

    @property
    def min_slo(self) -> float:
        return min((r.slo for r in self.requests), default=float("inf"))


@dataclass
class DeviceNode:
    """A hardware accelerator in the deployer's topology graph (paper §4.3)."""
    node_id: int
    memory: float            # bytes available for weights+KV
    performance: float       # FLOP/s effective
    name: str = ""


@dataclass
class DeviceMap:
    """layers[i] = number of model layers on path_order[i]; the paper's
    device-map output of HELR."""
    path: list[int] = field(default_factory=list)       # device ids in order
    layers: dict[int, int] = field(default_factory=dict)  # device id -> #layers
    est_latency: float = float("inf")
    est_util: float = 0.0

    def as_ranges(self, n_layers: int) -> list[tuple[int, int, int]]:
        """[(device_id, layer_lo, layer_hi)] pipeline ranges."""
        out, lo = [], 0
        for d in self.path:
            hi = lo + self.layers.get(d, 0)
            out.append((d, lo, hi))
            lo = hi
        return out
