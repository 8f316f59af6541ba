"""Observability of the port: log-bucketed latency histograms and the
request-lifecycle tracer the paged engine holds."""
from repro_torch.obs.hist import Histogram  # noqa: F401
from repro_torch.obs.trace import (NULL_TRACER, LatencyBreakdown,  # noqa: F401
                                   Tracer)
