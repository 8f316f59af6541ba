"""Distributed pieces of the port: the heartbeat and straggler bookkeeping
the simulated cluster's health layer runs on and the training restart's
mesh plan (``fault_tolerance``); the collectives over a mesh's named axes
(``collectives``) and the launcher of a run's ranks (``ranks``), imported
by module."""
from repro_torch.distributed.fault_tolerance import (  # noqa: F401
    ElasticTopology, HeartbeatTracker, StragglerMitigator)
