"""UELLM core of the port: resource profiler, batch scheduler and backend
monitor, and the LLM deployer (HELR over a device topology, HELR-mesh over
the production mesh)."""
from repro_torch.core.monitor import Monitor, MonitorStats  # noqa: F401
from repro_torch.core.profiler import (LengthPredictor, PredictorConfig,  # noqa: F401
                                       ResourceProfiler, make_buckets)
from repro_torch.core.scheduler import (SCHEDULERS, SchedulerConfig,  # noqa: F401
                                        derive_chunk_tokens, get_scheduler,
                                        prefix_affinity_key, slo_odbs,
                                        spec_speedup)
from repro_torch.core.types import Batch, Request  # noqa: F401
from repro_torch.core.deployer import (DEPLOYERS, EXACT_DP_MAX,  # noqa: F401
                                       HELRConfig, MeshPlan, bgs,
                                       candidate_plans,
                                       default_even_deploy, he, helr,
                                       helr_mesh, lr)
from repro_torch.core.types import DeviceMap, DeviceNode  # noqa: F401
