"""Multi-replica cluster serving: SLO-aware routing + forecast-driven
autoscaling over replicated engines — heterogeneous multi-model fleets
included (per-model pools, joint placement/scaling), plus fault tolerance
(failure injection, health-checked routing, retry/re-dispatch, graceful
brownout — ``faults``).  The discrete-event loop lives in
``repro_torch.serving.simulator.simulate_cluster``.

Own copy of ``repro/serving/cluster``: host code on numpy, except that a
live ``Replica`` serves through the port's ``PagedEngine``."""
from repro_torch.serving.cluster.autoscaler import (  # noqa: F401
    ArrivalForecaster, Autoscaler, AutoscalerConfig, ScaleEvent)
from repro_torch.serving.cluster.faults import (  # noqa: F401
    FAULT_KINDS, FaultEvent, FaultPlan, HealthConfig, RetryConfig)
from repro_torch.serving.cluster.fleet import (  # noqa: F401
    Fleet, FleetAutoscaler, FleetAutoscalerConfig, FleetScaleEvent,
    ModelPoolSpec)
from repro_torch.serving.cluster.replica import (  # noqa: F401
    HardwareProfile, Replica, ReplicaStats)
from repro_torch.serving.cluster.router import (  # noqa: F401
    POLICIES, NoCompatiblePoolError, Router, RouterConfig, RouterStats)
