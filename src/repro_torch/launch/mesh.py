"""The production mesh as a shape: its axis names and sizes.  Port of
``repro/launch/mesh.py``.

The reference builds a ``jax.make_mesh`` of 256 devices (512 over two
pods) for its plans and dry runs; the port has no such fleet of ranks to
build it on, so it keeps the shape alone, which the deployer's plans and
``sharding.specs`` read.  A mesh of real ranks is ``sharding.mesh.Mesh``.
"""
from __future__ import annotations

from repro_torch.sharding.mesh import Mesh


def make_production_mesh(*, multi_pod: bool = False) -> dict[str, int]:
    """{"data": 16, "model": 16}, or with ``multi_pod`` {"pod": 2, "data":
    16, "model": 16}: axis names in mesh order, with their sizes."""
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


def mesh_shape_dict(mesh: Mesh | dict[str, int]) -> dict[str, int]:
    """Axis name -> size of a ``Mesh`` or of a mesh shape."""
    return dict(mesh.shape if isinstance(mesh, Mesh) else mesh)
