"""Online cost profiler: measured phase times from the span stream.

Own copy of ``repro/obs/profile.py``.

UELLM's resource profiler (§4.1) learns **online** from the serving loop;
until now this repo only did that for output lengths — every latency-facing
decision (SLO-ODBS, ``Replica.projected_finish``, ``capacity_rps``, Holt
autoscaling, slo_aware shedding) priced work through the static analytic
roofline ``LatencyModel``.  ``CostProfiler`` closes the loop:

* it **attaches as a sink** to the ``Tracer`` span stream (``tracer.
  add_sink(prof.on_event)``) and folds every decode / verify / prefill span
  into EMA + histogram cells keyed by *binned operating points* —
  decode/verify by (batch-bucket, kv-bucket, q_tokens), prefill by
  (batch-bucket, token-bucket) — so a measurement made at one operating
  point generalizes to its neighborhood without drowning distinct regimes
  in one average;
* cells are kept **per replica** (keyed by the span's ``track``), **per
  model** (keyed by the span's ``model`` arg, when present) *and* as a
  fleet-wide aggregate, so a heterogeneous multi-model fleet prices each
  replica from its own measurements, falls back to its *model's* pool
  aggregate for operating points the replica has not visited, and only
  then to the fleet view;
* with a ``reference`` pricing model attached it also maintains
  predicted-vs-observed **residual ratio** statistics (per-cell and
  per-phase weighted means plus log-bucketed ratio histograms — the
  histograms are what quantile pricing reads) and **drift detection**:
  when a *replica's* phase calibration ratio leaves the ``1 ± drift_tol``
  band a ``profile_drift`` instant is emitted back into the trace on that
  replica's track (once per band crossing per replica, not per sample);
* with ``half_life`` set, ratio statistics decay with that sample
  half-life and every histogram becomes a two-window
  ``RotatingHistogram``, so a migrated or throttled replica re-learns
  within a bounded number of samples instead of averaging against its
  entire stale history forever (``half_life=None`` keeps the cumulative
  never-forgets statistics);
* it carries the **measured speculative-acceptance EMA** fed by
  ``PagedEngine._spec_step`` — the live replacement for the static
  ``SPEC_ACCEPT_PRIOR`` planning constant;
* profiles persist as a versioned JSON **registry** (``save``/``load``)
  with per-replica and per-model sub-profiles (v3); v2 registries still
  load as a single-model profile (no per-model scopes) and legacy v1
  registries load as a fleet-only profile.

Span producers carry the operating point in ``args``: ``batch``/``kv``/
``q_tokens`` on decode/verify spans, ``tokens`` on prefill spans, and
``iters`` on the cluster replica's ``batch_decode`` drain span (the sink
normalizes the drain to per-iteration cost).  Spans without these args are
ignored — old traces stay consumable.  One engine iteration emits one span
per *slot* sharing identical (t0, dur); the sink deduplicates those so a
batch-of-8 decode records one kernel sample, not eight.
"""
from __future__ import annotations

import json
import math
import pathlib
from dataclasses import dataclass, field
from typing import Optional

from repro_torch.obs.hist import (DEFAULT_GROWTH, DEFAULT_V_MIN, Histogram,
                            RotatingHistogram)
from repro_torch.obs.trace import TraceEvent, Tracer

# every histogram the profiler constructs uses the default bucketing, so
# one sample's bucket index can be computed once and fed to all of them
# (cell + residual + ratio histograms: record_idx instead of record)
_ILG = 1.0 / math.log(DEFAULT_GROWTH)


def _bidx(v: float) -> int:
    if v <= DEFAULT_V_MIN:
        return 0
    return 1 + int(math.log(v / DEFAULT_V_MIN) * _ILG)

PROFILE_VERSION = 3

# planning bootstrap for speculative acceptance before any measurement
# exists (repetitive MLaaS traffic with the n-gram drafter lands 0.4-0.8;
# the EMA replaces this after the first verify pass)
SPEC_ACCEPT_BOOTSTRAP = 0.5


# ------------------------------------------------------- operating-point bins

def batch_bucket(batch: int) -> int:
    """Batch-width bin: exact at small widths (1..4, where batching effects
    change fastest), next power of two above."""
    b = max(1, int(batch))
    if b <= 4:
        return b
    return 1 << (b - 1).bit_length()


def token_bucket(tokens: float) -> int:
    """Half-octave log2 bin for kv lengths / chunk token counts (factor
    sqrt(2) wide: fine enough that a cell's samples share a cost regime,
    coarse enough that projections hit cells execution populated)."""
    t = float(tokens)
    if t < 1.0:
        return 0
    return 1 + int(2.0 * math.log2(t))


kv_bucket = token_bucket      # same binning, named for the decode key


# ------------------------------------------------------------------ the cells

@dataclass
class CostCell:
    """Measured statistics of one (phase, operating-point) bin.

    The calibration ratio is a (numerator, denominator) weighted mean so
    one representation covers both memories: without decay it is the
    cumulative mean over every sample ever seen; with a profiler
    ``half_life`` both terms decay per unit weight, giving an estimate
    dominated by the last ~2 half-lives of samples.  ``ratio_hist`` holds
    the observed/predicted distribution quantile pricing reads."""
    count: int = 0
    ema_s: float = 0.0                 # EMA of observed seconds
    total_s: float = 0.0
    hist: object = field(default_factory=Histogram)
    ratio_count: int = 0               # samples with a reference prediction
    ratio_num: float = 0.0             # decayed weighted sum of obs/pred
    ratio_den: float = 0.0             # matching weight mass
    ratio_hist: object = field(default_factory=Histogram)

    @property
    def mean_s(self) -> float:
        return self.total_s / self.count if self.count else float("nan")

    @property
    def ratio_ema(self) -> float:
        """Working obs/pred estimate (kept under its historical name)."""
        return self.ratio_num / self.ratio_den if self.ratio_den > 0 else 1.0


class SubProfile:
    """Cost cells + residual statistics for one scope: the fleet aggregate
    or a single replica.  Drift detection state lives here so bands re-arm
    independently per replica."""

    def __init__(self):
        self.cells: dict[tuple, CostCell] = {}
        self.residual: dict[str, object] = {}     # phase -> ratio hist
        self.phase_ratio: dict[str, list] = {}    # phase -> [count, num, den]
        self.drift_out: dict[str, bool] = {}      # phase -> out of band?
        self.drift_events = 0


def _hist_to_json(h) -> dict:
    if isinstance(h, RotatingHistogram):
        return {"window": h.window,
                "active": _hist_to_json(h.active),
                "previous": _hist_to_json(h.previous)}
    return {"growth": h.growth, "v_min": h.v_min,
            "counts": {str(k): v for k, v in h.counts.items()},
            "n": h.n, "total": h.total,
            "min_v": None if math.isinf(h.min_v) else h.min_v,
            "max_v": None if math.isinf(h.max_v) else h.max_v}


def _hist_from_json(d: dict):
    if "window" in d:
        a = _hist_from_json(d["active"])
        return RotatingHistogram(d["window"], growth=a.growth,
                                 v_min=a.v_min, active=a,
                                 previous=_hist_from_json(d["previous"]))
    return Histogram(
        growth=d["growth"], v_min=d["v_min"],
        counts={int(k): v for k, v in d["counts"].items()},
        n=d["n"], total=d["total"],
        min_v=float("inf") if d["min_v"] is None else d["min_v"],
        max_v=float("-inf") if d["max_v"] is None else d["max_v"])


class CostProfiler:
    """Online EMA + histogram cells of measured phase times, keyed by
    binned operating points and scoped per replica with a fleet-wide
    aggregate, with residual/drift tracking against an optional
    ``reference`` pricing model, optional half-life decay, and a measured
    speculative-acceptance EMA.  See the module docstring for the full
    contract."""

    _SPAN_PHASE = {"decode": "decode", "verify": "decode",
                   "batch_decode": "decode",
                   "prefill_chunk": "prefill", "batch_prefill": "prefill"}

    def __init__(self, *, alpha: float = 0.25, drift_tol: float = 0.25,
                 drift_min_samples: int = 8, reference=None,
                 tracer: Optional[Tracer] = None,
                 spec_bootstrap: float = SPEC_ACCEPT_BOOTSTRAP,
                 half_life: Optional[int] = None, monitor=None):
        self.alpha = alpha
        self.drift_tol = drift_tol
        self.drift_min_samples = drift_min_samples
        self.reference = reference        # pricing model residuals compare to
        #   (the setter property resets the prediction memo below)
        self.tracer = tracer              # where profile_drift instants land
        self.monitor = monitor            # optional Monitor.observe_drift hook
        self.half_life = None if not half_life else int(half_life)
        # per-unit-weight retention of the ratio statistics: after
        # ``half_life`` samples old evidence carries half its weight
        self._decay = 2.0 ** (-1.0 / self.half_life) if self.half_life \
            else 1.0
        self.fleet = SubProfile()
        self.replica_profiles: dict[int, SubProfile] = {}
        self.model_profiles: dict[str, SubProfile] = {}
        self._replica_model: dict[int, str] = {}  # learned from span args
        self._drift_imported = 0          # v1 registries carry only a total
        self._last_key: dict[tuple, tuple] = {}  # (phase, track) -> dedupe
        # measured speculative acceptance (PagedEngine._spec_step feeds it)
        self.spec_drafted = 0
        self.spec_accepted = 0
        self.spec_samples = 0
        self._spec_ema = float(spec_bootstrap)
        self._spec_bootstrap = float(spec_bootstrap)

    # ------------------------------------------------------ reference pricing
    @property
    def reference(self):
        return self._reference

    @reference.setter
    def reference(self, lm) -> None:
        # the span hot path memoizes reference predictions by exact
        # operating point (they repeat heavily: every full chunk prefills
        # the same token budget) — swap of the model drops the memo
        self._reference = lm
        self._pred_cache: dict = {}

    # ------------------------------------------------- fleet-view back-compat
    @property
    def cells(self) -> dict:
        """Fleet-aggregate cells (the pre-v2 flat view)."""
        return self.fleet.cells

    @property
    def residual(self) -> dict:
        return self.fleet.residual

    @property
    def phase_ratio(self) -> dict:
        return self.fleet.phase_ratio

    @property
    def drift_events(self) -> int:
        """Total band crossings across every replica (plus any count
        imported from a v1 registry, which had no attribution)."""
        return self._drift_imported + sum(
            s.drift_events for s in self.replica_profiles.values())

    def drift_by_replica(self) -> dict[int, int]:
        """Band crossings attributed to each replica (non-zero only)."""
        return {rid: sub.drift_events
                for rid, sub in sorted(self.replica_profiles.items())
                if sub.drift_events}

    def drift_by_model(self) -> dict[str, int]:
        """Band crossings rolled up to the model each drifting replica was
        serving (non-zero only).  Replicas whose spans never carried a
        ``model`` arg are skipped — single-model runs report nothing here."""
        out: dict[str, int] = {}
        for rid, sub in sorted(self.replica_profiles.items()):
            m = self._replica_model.get(rid)
            if m and sub.drift_events:
                out[m] = out.get(m, 0) + sub.drift_events
        return out

    # ------------------------------------------------------------- histograms
    def _new_hist(self):
        if self.half_life:
            return RotatingHistogram(max(1, 2 * self.half_life))
        return Histogram()

    def _new_cell(self) -> CostCell:
        return CostCell(hist=self._new_hist(), ratio_hist=self._new_hist())

    def _ratio_fold(self, num: float, den: float, ratio: float,
                    w: int) -> tuple:
        """One weighted ratio sample folded into a (num, den) pair:
        cumulative weighted mean without decay, half-life-decayed weighted
        mean with it (each unit of weight multiplies the old mass by
        ``2**(-1/half_life)``)."""
        if self._decay >= 1.0:
            return num + ratio * w, den + w
        if w == 1:            # hot path: unit weight needs no pow
            d = self._decay
            return num * d + ratio, den * d + 1.0
        g = self._decay ** w
        s = (1.0 - g) / (1.0 - self._decay)
        return num * g + ratio * s, den * g + s

    # ------------------------------------------------------------- span sink
    def on_event(self, ev: TraceEvent) -> None:
        """Tracer-sink entry point: fold one span into the cells.  Ignores
        instants, spans outside the cost vocabulary, and spans without
        operating-point args; deduplicates the per-slot copies one engine
        iteration emits (identical t0/dur within a phase and track).  The
        span's ``track`` is the replica the sample is attributed to.

        This is the serve path's per-span hot path (gated by
        interleave_bench's 5% profiling-overhead budget), so the
        key/prediction computation of ``observe_decode``/``observe_prefill``
        is inlined here rather than called through them."""
        if ev.ph != "X":
            return
        phase = self._SPAN_PHASE.get(ev.name)
        if phase is None:
            return
        dk = (phase, ev.track)
        sig = (ev.t0, ev.dur)      # slot copies re-emit the same floats
        if self._last_key.get(dk) == sig:
            return
        self._last_key[dk] = sig
        args = ev.args or {}
        t_end = ev.t0 + ev.dur
        ref = self.reference
        model = str(args.get("model", "") or "")
        if phase == "decode":
            batch, kv = args.get("batch"), args.get("kv")
            if batch is None or kv is None or ev.dur <= 0:
                return
            q = int(args.get("q_tokens", 1))
            iters = float(args.get("iters", 1.0))
            if iters <= 0:
                return
            batch, kv = int(batch), float(kv)
            key = ("decode", batch_bucket(batch), kv_bucket(kv), q)
            pred = None
            if ref is not None:
                pc = self._pred_cache
                pred = pc.get((batch, kv, q))
                if pred is None:
                    if len(pc) > 8192:
                        pc.clear()
                    pred = pc[(batch, kv, q)] = \
                        ref.token_time(batch, kv, q_tokens=q)
            self._observe(key, "decode", ev.dur / iters, pred,
                          max(1, int(iters)), t_end, int(ev.track), model)
        else:
            tokens = args.get("tokens")
            if not tokens or ev.dur <= 0:
                return
            batch, tokens = int(args.get("batch", 1)), int(tokens)
            key = ("prefill", batch_bucket(batch), token_bucket(tokens))
            pred = None
            if ref is not None:
                pc = self._pred_cache
                pred = pc.get((batch, tokens))
                if pred is None:
                    if len(pc) > 8192:
                        pc.clear()
                    pred = pc[(batch, tokens)] = \
                        ref.prefill_time(batch, tokens)
            self._observe(key, "prefill", ev.dur, pred, 1, t_end,
                          int(ev.track), model)

    # -------------------------------------------------------- direct observe
    def observe_decode(self, seconds: float, *, batch: int, kv: float,
                       q_tokens: int = 1, weight: int = 1,
                       t: Optional[float] = None, replica: int = 0,
                       model: str = "") -> None:
        """One measured decode/verify iteration at (batch, kv, q_tokens)."""
        key = ("decode", batch_bucket(batch), kv_bucket(kv), int(q_tokens))
        pred = None
        if self.reference is not None:
            pred = self.reference.token_time(batch, kv, q_tokens=q_tokens)
        self._observe(key, "decode", seconds, pred, weight, t, replica, model)

    def observe_prefill(self, seconds: float, *, batch: int, tokens: int,
                        weight: int = 1, t: Optional[float] = None,
                        replica: int = 0, model: str = "") -> None:
        """One measured prefill call of ``tokens`` tokens at ``batch``."""
        key = ("prefill", batch_bucket(batch), token_bucket(tokens))
        pred = None
        if self.reference is not None:
            pred = self.reference.prefill_time(batch, tokens)
        self._observe(key, "prefill", seconds, pred, weight, t, replica,
                      model)

    def _observe(self, key: tuple, phase: str, obs: float,
                 pred: Optional[float], weight: int,
                 t: Optional[float], replica: int, model: str = "") -> None:
        # bucket the sample once: the same (value, index) pair feeds the
        # fleet and replica copies of every histogram it lands in
        hv = obs if obs > 0.0 else 0.0
        oidx = _bidx(hv)
        if pred is not None and pred > 0:
            ratio = obs / pred
            ridx = _bidx(ratio)
        else:
            ratio, ridx = None, 0
        self._observe_into(self.fleet, key, phase, obs, hv, oidx,
                           ratio, ridx, weight)
        if model:
            self._replica_model[replica] = model
            msub = self.model_profiles.get(model)
            if msub is None:
                msub = self.model_profiles[model] = SubProfile()
            self._observe_into(msub, key, phase, obs, hv, oidx,
                               ratio, ridx, weight)
        sub = self.replica_profiles.get(replica)
        if sub is None:
            sub = self.replica_profiles[replica] = SubProfile()
        if self._observe_into(sub, key, phase, obs, hv, oidx,
                              ratio, ridx, weight):
            # drift fires on the replica's own band, never on the fleet
            # aggregate — one slow replica must not look like fleet drift
            self._check_drift(replica, sub, phase, t)

    def _observe_into(self, sub: SubProfile, key: tuple, phase: str,
                      obs: float, hv: float, oidx: int,
                      ratio: Optional[float], ridx: int,
                      weight: int) -> bool:
        cell = sub.cells.get(key)
        if cell is None:
            cell = sub.cells[key] = self._new_cell()
        first = cell.count == 0
        cell.count += weight
        cell.total_s += obs * weight
        cell.ema_s = obs if first \
            else (1 - self.alpha) * cell.ema_s + self.alpha * obs
        cell.hist.record_idx(oidx, hv)
        if ratio is None:
            return False
        cell.ratio_num, cell.ratio_den = self._ratio_fold(
            cell.ratio_num, cell.ratio_den, ratio, weight)
        cell.ratio_count += weight
        cell.ratio_hist.record_idx(ridx, ratio)
        h = sub.residual.get(phase)
        if h is None:
            h = sub.residual[phase] = self._new_hist()
        h.record_idx(ridx, ratio)
        pr = sub.phase_ratio.get(phase)
        if pr is None:
            pr = sub.phase_ratio[phase] = [0, 0.0, 0.0]
        pr[1], pr[2] = self._ratio_fold(pr[1], pr[2], ratio, weight)
        pr[0] += weight
        return True

    def _check_drift(self, replica: int, sub: SubProfile, phase: str,
                     t: Optional[float]) -> None:
        """Band-crossing drift detection on one replica's phase calibration
        ratio: emit one ``profile_drift`` instant (on that replica's track,
        with replica attribution in args) when the ratio *leaves* the
        tolerance band, re-arming once it returns — not one per sample."""
        pr = sub.phase_ratio.get(phase)
        if pr is None or pr[0] < self.drift_min_samples or pr[2] <= 0:
            return
        ratio = pr[1] / pr[2]
        out = abs(ratio - 1.0) > self.drift_tol
        was_out = sub.drift_out.get(phase, False)
        sub.drift_out[phase] = out
        if out and not was_out:
            sub.drift_events += 1
            if self.monitor is not None:
                self.monitor.observe_drift(replica, phase)
            if self.tracer is not None:
                self.tracer.instant(
                    "profile_drift", t if t is not None else 0.0,
                    track=replica,
                    args={"replica": replica, "phase": phase,
                          "ratio": round(ratio, 4), "tol": self.drift_tol})

    # -------------------------------------------------- speculative acceptance
    def observe_acceptance(self, accepted: int, drafted: int) -> None:
        """One verify pass's acceptance sample (``PagedEngine._spec_step``)."""
        if drafted <= 0:
            return
        self.spec_drafted += drafted
        self.spec_accepted += accepted
        ratio = accepted / drafted
        self._spec_ema = ratio if self.spec_samples == 0 \
            else (1 - self.alpha) * self._spec_ema + self.alpha * ratio
        self.spec_samples += 1

    @property
    def spec_acceptance(self) -> float:
        """Measured-acceptance EMA; the bootstrap prior until the first
        verify pass has been observed."""
        return self._spec_ema if self.spec_samples else self._spec_bootstrap

    # ---------------------------------------------------------------- lookup
    def _sub(self, replica: Optional[int],
             model: Optional[str] = None) -> Optional[SubProfile]:
        if replica is not None:
            return self.replica_profiles.get(replica)
        if model:
            return self.model_profiles.get(model)
        return self.fleet

    def decode_cell(self, batch: int, kv: float, q_tokens: int = 1,
                    *, replica: Optional[int] = None,
                    model: Optional[str] = None) -> Optional[CostCell]:
        sub = self._sub(replica, model)
        if sub is None:
            return None
        return sub.cells.get(("decode", batch_bucket(batch),
                              kv_bucket(kv), int(q_tokens)))

    def prefill_cell(self, batch: int, tokens: float,
                     *, replica: Optional[int] = None,
                     model: Optional[str] = None) -> Optional[CostCell]:
        sub = self._sub(replica, model)
        if sub is None:
            return None
        return sub.cells.get(("prefill", batch_bucket(batch),
                              token_bucket(tokens)))

    def phase_correction(self, phase: str, *,
                         replica: Optional[int] = None,
                         model: Optional[str] = None,
                         quantile: Optional[float] = None
                         ) -> tuple[float, int]:
        """(calibration ratio, sample count) for a phase — the scope-wide
        multiplicative correction for operating points no cell covers.
        Scope precedence: ``replica`` if given, else ``model``'s pool
        aggregate, else the fleet aggregate.  With ``quantile`` set the
        ratio is that quantile of the phase residual histogram (tail
        pricing) instead of the weighted mean."""
        sub = self._sub(replica, model)
        if sub is None:
            return (1.0, 0)
        pr = sub.phase_ratio.get(phase)
        if pr is None or pr[2] <= 0:
            return (1.0, 0)
        if quantile is not None:
            h = sub.residual.get(phase)
            if h is not None and h.n:
                return (h.quantile(quantile), pr[0])
        return (pr[1] / pr[2], pr[0])

    # ------------------------------------------------------------- reporting
    def coverage(self) -> dict:
        """Per-phase cell and sample counts over the fleet aggregate (the
        coverage counters the metrics schema's profile block publishes)."""
        out: dict = {}
        for (phase, *_), cell in self.fleet.cells.items():
            d = out.setdefault(phase, {"cells": 0, "samples": 0})
            d["cells"] += 1
            d["samples"] += cell.count
        return out

    @staticmethod
    def _sub_coverage(sub: SubProfile) -> dict:
        d: dict = {}
        for (phase, *_), cell in sub.cells.items():
            p = d.setdefault(phase, {"cells": 0, "samples": 0})
            p["cells"] += 1
            p["samples"] += cell.count
        return d

    def replica_coverage(self) -> dict:
        """Per-replica per-phase cell/sample counts."""
        return {rid: self._sub_coverage(sub)
                for rid, sub in sorted(self.replica_profiles.items())}

    def model_coverage(self) -> dict:
        """Per-model per-phase cell/sample counts (empty for single-model
        runs whose spans carry no ``model`` arg)."""
        return {m: self._sub_coverage(sub)
                for m, sub in sorted(self.model_profiles.items())}

    @staticmethod
    def _sub_ratios(sub: SubProfile) -> dict:
        return {ph: round(pr[1] / pr[2], 4)
                for ph, pr in sub.phase_ratio.items() if pr[2] > 0}

    def metrics(self) -> dict:
        """The metrics-JSON ``profile`` block (schema v5): coverage,
        residual quantiles, calibration ratios, per-replica and per-model
        drift attribution, measured acceptance."""
        out = {
            "version": PROFILE_VERSION,
            "coverage": self.coverage(),
            "cells": len(self.fleet.cells),
            "drift_events": self.drift_events,
        }
        if self.half_life:
            out["half_life"] = self.half_life
        if self.fleet.residual:
            out["residual"] = {ph: h.summary()
                               for ph, h in self.fleet.residual.items()}
            out["calibration_ratio"] = self._sub_ratios(self.fleet)
        drift = self.drift_by_replica()
        if drift:
            out["drift_by_replica"] = {str(r): n for r, n in drift.items()}
        mdrift = self.drift_by_model()
        if mdrift:
            out["drift_by_model"] = mdrift
        if self.replica_profiles:
            out["replicas"] = {
                str(rid): {"cells": len(sub.cells),
                           "drift_events": sub.drift_events,
                           "calibration_ratio": self._sub_ratios(sub)}
                for rid, sub in sorted(self.replica_profiles.items())}
        if self.model_profiles:
            out["models"] = {
                m: {"cells": len(sub.cells),
                    "samples": sum(c.count for c in sub.cells.values()),
                    "calibration_ratio": self._sub_ratios(sub)}
                for m, sub in sorted(self.model_profiles.items())}
        if self.spec_samples:
            out["spec_acceptance"] = round(self.spec_acceptance, 4)
            out["spec_samples"] = self.spec_samples
        return out

    # -------------------------------------------------------------- registry
    @staticmethod
    def _sub_to_json(sub: SubProfile) -> dict:
        return {
            "cells": [
                {"key": list(key), "count": c.count, "ema_s": c.ema_s,
                 "total_s": c.total_s, "ratio_count": c.ratio_count,
                 "ratio_num": c.ratio_num, "ratio_den": c.ratio_den,
                 "hist": _hist_to_json(c.hist),
                 "ratio_hist": _hist_to_json(c.ratio_hist)}
                for key, c in sorted(sub.cells.items())],
            "residual": {ph: _hist_to_json(h)
                         for ph, h in sub.residual.items()},
            "phase_ratio": {ph: list(pr)
                            for ph, pr in sub.phase_ratio.items()},
            "drift_events": sub.drift_events,
        }

    def _sub_from_json(self, d: dict) -> SubProfile:
        sub = SubProfile()
        for c in d["cells"]:
            sub.cells[tuple(c["key"])] = CostCell(
                count=c["count"], ema_s=c["ema_s"], total_s=c["total_s"],
                hist=_hist_from_json(c["hist"]),
                ratio_count=c["ratio_count"], ratio_num=c["ratio_num"],
                ratio_den=c["ratio_den"],
                ratio_hist=_hist_from_json(c["ratio_hist"]))
        sub.residual = {ph: _hist_from_json(h)
                        for ph, h in d["residual"].items()}
        sub.phase_ratio = {ph: list(pr)
                           for ph, pr in d["phase_ratio"].items()}
        sub.drift_events = d.get("drift_events", 0)
        for ph, pr in sub.phase_ratio.items():
            sub.drift_out[ph] = pr[0] >= self.drift_min_samples \
                and pr[2] > 0 and abs(pr[1] / pr[2] - 1.0) > self.drift_tol
        return sub

    def to_json(self) -> dict:
        """Versioned profile registry payload (everything ``from_json``
        needs to reproduce this profiler's predictions exactly), with one
        sub-profile per replica and per model plus the fleet aggregate."""
        return {
            "profile_version": PROFILE_VERSION,
            "alpha": self.alpha,
            "drift_tol": self.drift_tol,
            "drift_min_samples": self.drift_min_samples,
            "half_life": self.half_life,
            "drift_events": self.drift_events,
            "drift_imported": self._drift_imported,
            "fleet": self._sub_to_json(self.fleet),
            "replicas": {str(rid): self._sub_to_json(sub)
                         for rid, sub in
                         sorted(self.replica_profiles.items())},
            "models": {m: self._sub_to_json(sub)
                       for m, sub in sorted(self.model_profiles.items())},
            "replica_models": {str(rid): m for rid, m in
                               sorted(self._replica_model.items())},
            "spec": {"drafted": self.spec_drafted,
                     "accepted": self.spec_accepted,
                     "samples": self.spec_samples,
                     "ema": self._spec_ema,
                     "bootstrap": self._spec_bootstrap},
        }

    @classmethod
    def from_json(cls, obj: dict, *, reference=None,
                  tracer: Optional[Tracer] = None) -> "CostProfiler":
        v = obj.get("profile_version")
        if v == 1:
            return cls._from_json_v1(obj, reference=reference, tracer=tracer)
        if v not in (2, PROFILE_VERSION):
            raise ValueError(f"unsupported profile_version {v!r} "
                             f"(this build reads {PROFILE_VERSION} and "
                             f"legacy 1-2)")
        prof = cls(alpha=obj["alpha"], drift_tol=obj["drift_tol"],
                   drift_min_samples=obj["drift_min_samples"],
                   reference=reference, tracer=tracer,
                   spec_bootstrap=obj["spec"]["bootstrap"],
                   half_life=obj.get("half_life"))
        prof._drift_imported = obj.get("drift_imported", 0)
        prof.fleet = prof._sub_from_json(obj["fleet"])
        prof.replica_profiles = {int(rid): prof._sub_from_json(d)
                                 for rid, d in obj["replicas"].items()}
        # v2 registries predate model scopes: they load as a single-model
        # profile (no per-model sub-profiles, no replica->model map) and
        # per-model lookups fall back to the fleet aggregate
        prof.model_profiles = {m: prof._sub_from_json(d)
                               for m, d in obj.get("models", {}).items()}
        prof._replica_model = {int(rid): m for rid, m in
                               obj.get("replica_models", {}).items()}
        sp = obj["spec"]
        prof.spec_drafted = sp["drafted"]
        prof.spec_accepted = sp["accepted"]
        prof.spec_samples = sp["samples"]
        prof._spec_ema = sp["ema"]
        return prof

    @classmethod
    def _from_json_v1(cls, obj: dict, *, reference=None,
                      tracer: Optional[Tracer] = None) -> "CostProfiler":
        """Legacy flat registries (v1) load as a fleet-only profile: their
        cells had no replica attribution, so per-replica lookups fall back
        to the fleet aggregate until fresh spans repopulate them.  The v1
        ratio EMA becomes an equivalent (num, den) weighted mean."""
        prof = cls(alpha=obj["alpha"], drift_tol=obj["drift_tol"],
                   drift_min_samples=obj["drift_min_samples"],
                   reference=reference, tracer=tracer,
                   spec_bootstrap=obj["spec"]["bootstrap"])
        prof._drift_imported = obj.get("drift_events", 0)
        for c in obj["cells"]:
            rc = c["ratio_count"]
            prof.fleet.cells[tuple(c["key"])] = CostCell(
                count=c["count"], ema_s=c["ema_s"], total_s=c["total_s"],
                hist=_hist_from_json(c["hist"]), ratio_count=rc,
                ratio_num=c["ratio_ema"] * rc, ratio_den=float(rc))
        prof.fleet.residual = {ph: _hist_from_json(h)
                               for ph, h in obj["residual"].items()}
        prof.fleet.phase_ratio = {
            ph: [pr[0], pr[1] * pr[0], float(pr[0])]
            for ph, pr in obj["phase_ratio"].items()}
        sp = obj["spec"]
        prof.spec_drafted = sp["drafted"]
        prof.spec_accepted = sp["accepted"]
        prof.spec_samples = sp["samples"]
        prof._spec_ema = sp["ema"]
        return prof

    def save(self, path) -> None:
        pathlib.Path(path).write_text(json.dumps(self.to_json(), indent=1))

    @classmethod
    def load(cls, path, *, reference=None,
             tracer: Optional[Tracer] = None) -> "CostProfiler":
        return cls.from_json(json.loads(pathlib.Path(path).read_text()),
                             reference=reference, tracer=tracer)
