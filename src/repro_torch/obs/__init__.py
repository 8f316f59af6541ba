"""Observability of the port (own copy of ``repro/obs``): request-lifecycle
spans, log-bucketed latency histograms, Chrome-trace/Perfetto export, the
shared metrics JSON schema, and the online cost profiler + calibrated
pricing that close the measurement loop back into scheduling decisions."""
from repro_torch.obs.calibrate import CalibratedLatencyModel  # noqa: F401
from repro_torch.obs.export import (event_names, export_trace,  # noqa: F401
                                    metrics_payload, to_chrome,
                                    validate_metrics, validate_trace,
                                    write_metrics)
from repro_torch.obs.hist import Histogram, RotatingHistogram  # noqa: F401
from repro_torch.obs.profile import (PROFILE_VERSION, CostCell,  # noqa: F401
                                     CostProfiler, SubProfile, batch_bucket,
                                     kv_bucket, token_bucket)
from repro_torch.obs.trace import (EVENT_NAMES, INSTANT_NAMES,  # noqa: F401
                                   NULL_TRACER, ROW_ENGINE, ROW_QUEUE,
                                   SPAN_NAMES, LatencyBreakdown, TraceEvent,
                                   Tracer, check_invariants, slot_row)
