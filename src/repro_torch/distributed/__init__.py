"""Host-side control plane of the port: the heartbeat and straggler
bookkeeping the simulated cluster's health layer runs on, and the training
restart's mesh plan."""
from repro_torch.distributed.fault_tolerance import (  # noqa: F401
    ElasticTopology, HeartbeatTracker, StragglerMitigator)
