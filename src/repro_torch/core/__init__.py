"""UELLM core of the port: resource profiler, batch scheduler and backend
monitor of the single-engine serve paths."""
from repro_torch.core.monitor import Monitor, MonitorStats  # noqa: F401
from repro_torch.core.profiler import (LengthPredictor, PredictorConfig,  # noqa: F401
                                       ResourceProfiler, make_buckets)
from repro_torch.core.scheduler import (SCHEDULERS, SchedulerConfig,  # noqa: F401
                                        derive_chunk_tokens, get_scheduler,
                                        slo_odbs)
from repro_torch.core.types import Batch, Request  # noqa: F401
