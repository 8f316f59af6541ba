"""Collectives over a named axis, or a tuple of axes, of the current mesh.

The port's counterparts of ``lax.psum`` / ``pmax`` / ``pmean`` /
``all_gather`` / ``psum_scatter`` / ``all_to_all`` / ``axis_index`` inside
the reference's ``shard_map`` bodies, and of the layout changes XLA
inserts for its ``with_sharding_constraint`` calls.  Each takes this
rank's tensor and returns a new one (the input is never written).  Over an
axis of size 1, or outside any mesh, each is the identity.

The backend is the mesh's, fixed when it was made: on gloo a CUDA tensor
goes through host memory for every call (gloo's collectives run on host
buffers); on NCCL it stays on the card.  ``reduce_scatter`` is an
all-reduce followed by taking this rank's slice on either.  The groups'
ranks are row-major over the axes, so a gather concatenates the shards in
the reference's order.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.sharding.mesh import Axes, Mesh, axis_size, current_mesh


def _mesh() -> Mesh | None:
    return current_mesh()


def axis_index(axis: Axes) -> int:
    """This rank's index along ``axis`` (row-major over a tuple)."""
    mesh = _mesh()
    return mesh.axis_index(axis) if mesh is not None else 0


def _send(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of x for the collective to fill: in host memory
    when the mesh stages CUDA tensors."""
    if mesh.stages(x):
        return x.detach().to("cpu").contiguous()
    return x.detach().contiguous().clone()


def _reduce(x: torch.Tensor, axis: Axes, op) -> torch.Tensor:
    mesh = _mesh()
    group = mesh.group(axis) if mesh is not None else None
    if group is None:
        return x
    buf = _send(mesh, x)
    dist.all_reduce(buf, op=op, group=group)
    return buf.to(x.device)


def psum(x: torch.Tensor, axis: Axes) -> torch.Tensor:
    return _reduce(x, axis, dist.ReduceOp.SUM)


def pmax(x: torch.Tensor, axis: Axes) -> torch.Tensor:
    return _reduce(x, axis, dist.ReduceOp.MAX)


def pmean(x: torch.Tensor, axis: Axes) -> torch.Tensor:
    return psum(x, axis) / axis_size(axis)


def all_gather(x: torch.Tensor, axis: Axes, dim: int) -> torch.Tensor:
    """Concatenate the shards of ``axis`` along ``dim``, in axis order."""
    mesh = _mesh()
    group = mesh.group(axis) if mesh is not None else None
    if group is None:
        return x
    buf = _send(mesh, x)
    parts = [torch.empty_like(buf) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, buf, group=group)
    return torch.cat(parts, dim=dim).to(x.device)


def local_chunk(x: torch.Tensor, axis: Axes, dim: int) -> torch.Tensor:
    """This rank's slice of ``x`` along ``dim`` when ``axis`` shards it
    (no communication); ``dim`` must divide evenly."""
    n = axis_size(axis)
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split over "
                         f"{n} shards of {axis}")
    size = x.shape[dim] // n
    return x.narrow(dim, axis_index(axis) * size, size).contiguous()


def reduce_scatter(x: torch.Tensor, axis: Axes, dim: int) -> torch.Tensor:
    """Sum over ``axis`` and keep this rank's slice along ``dim``."""
    return local_chunk(psum(x, axis), axis, dim)


def all_to_all(x: torch.Tensor, axis: Axes, split: int,
               concat: int) -> torch.Tensor:
    """Tiled all-to-all: ``x`` split along ``split`` into one chunk per
    rank of ``axis``, chunk j sent to rank j; the chunks received are
    concatenated along ``concat`` in rank order."""
    mesh = _mesh()
    group = mesh.group(axis) if mesh is not None else None
    if group is None:
        return x
    n = dist.get_world_size(group)
    if x.shape[split] % n:
        raise ValueError(f"dim {split} of {tuple(x.shape)} does not split "
                         f"over {n} ranks")
    send = _send(mesh, torch.stack(x.chunk(n, dim=split)))
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), dim=concat).to(x.device)
