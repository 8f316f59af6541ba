"""Serving runtime of the port: the padded and continuous engine, the paged
continuous-batching engine with its block allocator, prefix cache and
drafters, the greedy sampler, and the cluster layer (replicas, router,
autoscaler, fleet, faults) with its discrete-event simulator."""
from repro_torch.serving.engine import (BatchResult, EngineConfig,  # noqa: F401
                                        InferenceEngine)
from repro_torch.serving.kv_cache import (BlockAllocator, PagedKVCache,  # noqa: F401
                                          PagedKVConfig, kv_block_bytes)
from repro_torch.serving.paged_engine import (PagedBatchResult,  # noqa: F401
                                              PagedDecodeState, PagedEngine,
                                              PagedEngineConfig,
                                              PrefillProgress)
from repro_torch.serving.prefix_cache import (PrefixCache, PrefixMatch,  # noqa: F401
                                              RadixBlockTree)
from repro_torch.serving.sampling import greedy  # noqa: F401
from repro_torch.serving.speculative import (Drafter, ModelDrafter,  # noqa: F401
                                             NGramDrafter, get_drafter)
from repro_torch.serving.cluster import (  # noqa: F401
    Autoscaler, AutoscalerConfig, FaultEvent, FaultPlan, Fleet,
    FleetAutoscaler, FleetAutoscalerConfig, HardwareProfile, HealthConfig,
    ModelPoolSpec, NoCompatiblePoolError, Replica, RetryConfig, Router,
    RouterConfig)
from repro_torch.serving.simulator import (  # noqa: F401
    ClusterSimResult, ContinuousSimResult, LatencyModel, SimResult,
    morphling_deploy_overhead, paper_cluster, replicated_cluster, simulate,
    simulate_cluster, simulate_continuous)
