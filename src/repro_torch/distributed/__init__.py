"""Host-side control plane of the port: the heartbeat and straggler
bookkeeping the simulated cluster's health layer runs on."""
from repro_torch.distributed.fault_tolerance import (  # noqa: F401
    HeartbeatTracker, StragglerMitigator)
