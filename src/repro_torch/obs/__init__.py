"""Observability of the port: log-bucketed latency histograms."""
from repro_torch.obs.hist import Histogram  # noqa: F401
