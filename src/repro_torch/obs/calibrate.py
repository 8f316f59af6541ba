"""Calibrated pricing: analytic roofline × measured multiplicative residual.

Own copy of ``repro/obs/calibrate.py``.

The analytic ``LatencyModel`` prices every latency-facing decision
(SLO-ODBS, ``Replica.projected_finish``, ``capacity_rps``, Holt
autoscaling, slo_aware shedding) from first principles — flops over an
``efficiency`` knob, bytes over an ``hbm_bw`` knob — and those constants
are guesses.  ``CalibratedLatencyModel`` wraps the analytic model and a
``CostProfiler`` and corrects each prediction with the profiler's measured
observed/predicted ratio:

    predicted = analytic(op) × correction(op)

where ``correction`` resolves through a fallback chain, most-specific
scope first:

1. the matching cell's measured ratio in the *replica* sub-profile (when
   ``replica`` is set), then the replica's phase-wide ratio — a
   heterogeneous fleet prices each replica from its own hardware's
   evidence;
2. the matching cell in the *model's* pool aggregate (when ``model`` is
   set), then the model's phase-wide ratio — a fresh replica of model M
   inherits M's pool evidence instead of being polluted by other models'
   cost curves;
3. the matching *fleet* cell's ratio, when that cell holds at least
   ``min_samples`` reference-compared samples (coverage hit);
4. the fleet phase-wide ratio — a uniform miscalibration (e.g. efficiency
   off 2× on a compute-bound phase) shows up as a near-constant ratio, so
   the phase ratio generalizes to operating points execution never visited
   (projection cohorts, ``capacity_rps`` at full width);
5. 1.0 — pure analytic fallback when nothing was measured (coverage miss).

With ``quantile=q`` the correction at each step is the *q-quantile* of the
observed/predicted ratio histogram instead of its mean — tail pricing for
SLO decisions (shed/admit, ``projected_finish``, autoscaler capacity),
where guaranteeing a p99-gated SLO off a mean ratio systematically
under-prices the slow tail.  Mean pricing (``quantile=None``) remains the
default for throughput estimates.

A *ratio* correction rather than substituting measured seconds keeps the
analytic model's shape between bucket centers (log-binned cells would
otherwise quantize the prediction) and makes a well-calibrated model pass
through unchanged: ratios sit at 1.0, so calibrated == analytic exactly.
``cell_hits``/``cell_misses`` count the chain's resolutions for the
metrics-schema profile block.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.obs.profile import CostProfiler


class CalibratedLatencyModel:
    """Duck-types ``LatencyModel`` (``token_time``/``prefill_time`` plus
    attribute delegation for everything else: ``peak_flops``,
    ``efficiency``, ``_stage_flops_token`` …) so it drops into Replica,
    Router, Autoscaler, SchedulerConfig derivation, and the simulators
    anywhere the analytic model goes."""

    def __init__(self, analytic, profile: CostProfiler, *,
                 min_samples: int = 3, quantile: Optional[float] = None,
                 replica: Optional[int] = None,
                 model: Optional[str] = None):
        self.analytic = analytic
        self.profile = profile
        self.min_samples = min_samples
        self.quantile = quantile          # None = mean ratio; q = tail ratio
        self.replica = replica            # None = fleet-aggregate pricing
        self.model = model or None        # pool-aggregate fallback scope
        self.cell_hits = 0       # priced from a covered cell's ratio
        self.phase_hits = 0      # fell back to a phase-wide ratio
        self.cell_misses = 0     # pure analytic (no measurement at all)

    # ------------------------------------------------------------- pricing
    def _cell_ratio(self, cell) -> Optional[float]:
        """A covered cell's correction, or None below ``min_samples``.
        Quantile pricing reads the cell's ratio histogram; a cell restored
        from a legacy registry (no histogram) degrades to its mean."""
        if cell is None or cell.ratio_count < self.min_samples:
            return None
        if self.quantile is not None and cell.ratio_hist.n:
            return cell.ratio_hist.quantile(self.quantile)
        return cell.ratio_ema

    def _phase_ratio(self, phase: str, replica: Optional[int],
                     model: Optional[str] = None) -> Optional[float]:
        ratio, n = self.profile.phase_correction(
            phase, replica=replica, model=model, quantile=self.quantile)
        return ratio if n >= self.min_samples else None

    def _correction(self, phase: str, cells: tuple) -> float:
        """Resolve the fallback chain: replica cell → replica phase →
        model cell → model phase → fleet cell → fleet phase → 1.0
        (``cells`` is (replica, model, fleet); the replica/model entries
        are None for wider-scoped models)."""
        cell_rep, cell_model, cell_fleet = cells
        if self.replica is not None:
            r = self._cell_ratio(cell_rep)
            if r is not None:
                self.cell_hits += 1
                return r
            r = self._phase_ratio(phase, self.replica)
            if r is not None:
                self.phase_hits += 1
                return r
        if self.model is not None:
            r = self._cell_ratio(cell_model)
            if r is not None:
                self.cell_hits += 1
                return r
            r = self._phase_ratio(phase, None, self.model)
            if r is not None:
                self.phase_hits += 1
                return r
        r = self._cell_ratio(cell_fleet)
        if r is not None:
            self.cell_hits += 1
            return r
        r = self._phase_ratio(phase, None)
        if r is not None:
            self.phase_hits += 1
            return r
        self.cell_misses += 1
        return 1.0

    def token_time(self, batch: int, kv_tokens: float,
                   q_tokens: int = 1) -> float:
        base = self.analytic.token_time(batch, kv_tokens, q_tokens=q_tokens)
        cells = (self.profile.decode_cell(batch, kv_tokens, q_tokens,
                                          replica=self.replica)
                 if self.replica is not None else None,
                 self.profile.decode_cell(batch, kv_tokens, q_tokens,
                                          model=self.model)
                 if self.model is not None else None,
                 self.profile.decode_cell(batch, kv_tokens, q_tokens))
        return base * self._correction("decode", cells)

    def prefill_time(self, batch: int, in_len: int) -> float:
        base = self.analytic.prefill_time(batch, in_len)
        cells = (self.profile.prefill_cell(batch, in_len,
                                           replica=self.replica)
                 if self.replica is not None else None,
                 self.profile.prefill_cell(batch, in_len, model=self.model)
                 if self.model is not None else None,
                 self.profile.prefill_cell(batch, in_len))
        return base * self._correction("prefill", cells)

    # ----------------------------------------------------------- reporting
    def coverage_counters(self) -> dict:
        total = self.cell_hits + self.phase_hits + self.cell_misses
        out = {"cell_hits": self.cell_hits, "phase_hits": self.phase_hits,
               "cell_misses": self.cell_misses,
               "covered_frac": round(
                   (self.cell_hits + self.phase_hits) / total, 4)
               if total else 0.0}
        if self.quantile is not None:
            out["quantile"] = self.quantile
        if self.replica is not None:
            out["replica"] = self.replica
        if self.model is not None:
            out["model"] = self.model
        return out

    # everything else (cfg, efficiency, peak_flops, _stage_flops_token,
    # _stage_bytes, dmap …) is the analytic model's business
    def __getattr__(self, name):
        return getattr(self.analytic, name)
