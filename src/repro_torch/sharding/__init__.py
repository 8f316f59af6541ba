"""Sharding of the port: the plan the mesh deployer produces, the mesh of
ranks it runs on, and the parameter and cache layouts it implies."""
from repro_torch.sharding.mesh import Mesh, current_mesh, set_mesh  # noqa: F401
from repro_torch.sharding.plan import ShardingPlan  # noqa: F401
