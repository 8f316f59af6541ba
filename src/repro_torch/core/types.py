"""Core serving types shared by the profiler, scheduler, monitor and engine.

Own copy of ``repro/core/types.py``, trimmed to the single-engine serve path
(no cluster, fleet or retry bookkeeping)."""
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
    first_token_time: Optional[float] = None

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
