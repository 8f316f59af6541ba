"""Sharding of the port: the plan the mesh deployer produces."""
from repro_torch.sharding.plan import ShardingPlan  # noqa: F401
