"""Collectives over a named axis, or a tuple of axes, of the current mesh.

The port's counterparts of ``lax.psum`` / ``pmax`` / ``pmean`` /
``all_gather`` / ``psum_scatter`` / ``all_to_all`` / ``axis_index`` inside
the reference's ``shard_map`` bodies, and of the layout changes XLA
inserts for its ``with_sharding_constraint`` calls.  Each takes this
rank's tensor and returns a new one (the input is never written).  Over an
axis of size 1, or outside any mesh, each is the identity.

``psum``, ``all_gather``, ``local_chunk``, ``reduce_scatter`` and
``all_to_all`` carry a gradient: each is an ``autograd.Function`` whose
backward is its forward's transpose over the ranks (psum <-> psum,
all_gather <-> reduce_scatter, local_chunk <-> this rank's slice placed
into zeros, all_to_all <-> the reverse all_to_all), so autograd on every
rank computes the gradient of the sum of the ranks' outputs (the sharded
train step, ``training.trainer``, seeds each rank with 1 / ranks).  Under
``no_grad`` each runs its forward alone.  ``pmax`` carries none: the
reference takes it only of quantities it does not differentiate (softmax
maxima, int8 scales).

The backend is the mesh's, fixed when it was made: on gloo a CUDA tensor
goes through host memory for every call (gloo's collectives run on host
buffers, page-locked here, so the copies to and from the card run at the
bus's rate); on NCCL it stays on the card.  ``reduce_scatter`` is an
all-reduce followed by taking this rank's slice on either.  The groups'
ranks are row-major over the axes, so a gather concatenates the shards in
the reference's order.

``counts`` tallies every ``torch.distributed`` call issued here, by kind
(``all_reduce``, ``all_gather``, ``all_to_all``) and by the axes of its
group: calls, and this rank's input bytes to the call.  A backward counts
as the calls it makes (a psum's backward is an all_reduce).  ``reset`` and
``read`` it around a step, as the kernels' ``launches``; the dry run
(``launch.dryrun``) records it.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.sharding.mesh import Axes, Mesh, axis_size, current_mesh

KINDS = ("all_reduce", "all_gather", "all_to_all")


class CallCounts:
    """Calls and input bytes of the collectives issued, by (kind, axes)."""

    def __init__(self):
        self._by: dict[tuple[str, tuple[str, ...]], list[int]] = {}

    def add(self, kind: str, mesh: Mesh, group, x: torch.Tensor) -> None:
        entry = self._by.setdefault((kind, mesh.group_axes(group)), [0, 0])
        entry[0] += 1
        entry[1] += x.numel() * x.element_size()

    def reset(self) -> None:
        self._by.clear()

    def read(self) -> dict:
        """{"calls": {kind: n}, "bytes": {kind: n}, "by_axes": {"kind
        over a,b": {"calls", "bytes"}}}; every kind is listed."""
        calls = dict.fromkeys(KINDS, 0)
        nbytes = dict.fromkeys(KINDS, 0)
        by_axes = {}
        for (kind, axes), (n, b) in sorted(self._by.items()):
            calls[kind] += n
            nbytes[kind] += b
            by_axes[f"{kind} over {','.join(axes)}"] = {"calls": n, "bytes": b}
        return {"calls": calls, "bytes": nbytes, "by_axes": by_axes}


counts = CallCounts()


def axis_index(axis: Axes) -> int:
    """This rank's index along ``axis`` (row-major over a tuple)."""
    mesh = current_mesh()
    return mesh.axis_index(axis) if mesh is not None else 0


def _group(axis: Axes):
    """(mesh, its group for ``axis``), or (None, None) where the axis has
    size 1 or no mesh is set: the collective is then the identity."""
    mesh = current_mesh()
    group = mesh.group(axis) if mesh is not None else None
    return (mesh, group) if group is not None else (None, None)


def _host(shape, dtype) -> torch.Tensor:
    """A page-locked host buffer (PyTorch caches them, as it caches device
    memory)."""
    return torch.empty(shape, dtype=dtype, pin_memory=True)


def _send(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of x for the collective to fill: in page-locked
    host memory when the mesh stages CUDA tensors."""
    if mesh.stages(x):
        return _host(x.shape, x.dtype).copy_(x.detach())
    return x.detach().contiguous().clone()


def _all_reduce(mesh, group, x: torch.Tensor, op) -> torch.Tensor:
    counts.add("all_reduce", mesh, group, x)
    buf = _send(mesh, x)
    dist.all_reduce(buf, op=op, group=group)
    return buf.to(x.device)


def _all_gather(mesh, group, x: torch.Tensor, dim: int) -> torch.Tensor:
    counts.add("all_gather", mesh, group, x)
    buf = _send(mesh, x)
    n = dist.get_world_size(group)
    parts = [_host(buf.shape, buf.dtype) if mesh.stages(x)
             else torch.empty_like(buf) for _ in range(n)]
    dist.all_gather(parts, buf, group=group)
    return torch.cat([part.to(x.device) for part in parts], dim=dim)


def _slice(x: torch.Tensor, n: int, index: int, dim: int) -> torch.Tensor:
    size = x.shape[dim] // n
    return x.narrow(dim, index * size, size).contiguous()


def _place(g: torch.Tensor, n: int, index: int, dim: int) -> torch.Tensor:
    """g as slice ``index`` of ``n`` along ``dim`` of a zero tensor."""
    shape = list(g.shape)
    shape[dim] *= n
    out = g.new_zeros(shape)
    out.narrow(dim, index * g.shape[dim], g.shape[dim]).copy_(g)
    return out


def _all_to_all(mesh, group, x: torch.Tensor, split: int,
                concat: int) -> torch.Tensor:
    counts.add("all_to_all", mesh, group, x)
    n = dist.get_world_size(group)
    send = _send(mesh, torch.stack(x.chunk(n, dim=split)))
    recv = _host(send.shape, send.dtype) if mesh.stages(x) \
        else torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.to(x.device).unbind(0), dim=concat)


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, group):
        ctx.mesh, ctx.group = mesh, group
        return _all_reduce(mesh, group, x, dist.ReduceOp.SUM)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(ctx.mesh, ctx.group, g, dist.ReduceOp.SUM), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, group, dim, index):
        ctx.mesh, ctx.group, ctx.dim, ctx.index = mesh, group, dim, index
        return _all_gather(mesh, group, x, dim)

    @staticmethod
    def backward(ctx, g):
        n = dist.get_world_size(ctx.group)
        full = _all_reduce(ctx.mesh, ctx.group, g, dist.ReduceOp.SUM)
        return _slice(full, n, ctx.index, ctx.dim), None, None, None, None


class _LocalChunk(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, n, index, dim):
        ctx.n, ctx.index, ctx.dim = n, index, dim
        return _slice(x, n, index, dim)

    @staticmethod
    def backward(ctx, g):
        return _place(g, ctx.n, ctx.index, ctx.dim), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, group, dim, index):
        ctx.mesh, ctx.group, ctx.dim = mesh, group, dim
        n = dist.get_world_size(group)
        return _slice(_all_reduce(mesh, group, x, dist.ReduceOp.SUM), n,
                      index, dim)

    @staticmethod
    def backward(ctx, g):
        return (_all_gather(ctx.mesh, ctx.group, g, ctx.dim), None, None,
                None, None)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, group, split, concat):
        ctx.mesh, ctx.group, ctx.split, ctx.concat = mesh, group, split, concat
        return _all_to_all(mesh, group, x, split, concat)

    @staticmethod
    def backward(ctx, g):
        return (_all_to_all(ctx.mesh, ctx.group, g, ctx.concat, ctx.split),
                None, None, None, None)


def psum(x: torch.Tensor, axis: Axes) -> torch.Tensor:
    mesh, group = _group(axis)
    return x if group is None else _PSum.apply(x, mesh, group)


def pmax(x: torch.Tensor, axis: Axes) -> torch.Tensor:
    """The elementwise max over ``axis``; no gradient flows through it."""
    mesh, group = _group(axis)
    return x if group is None else _all_reduce(mesh, group, x,
                                               dist.ReduceOp.MAX)


def pmean(x: torch.Tensor, axis: Axes) -> torch.Tensor:
    return psum(x, axis) / axis_size(axis)


def all_gather(x: torch.Tensor, axis: Axes, dim: int) -> torch.Tensor:
    """Concatenate the shards of ``axis`` along ``dim``, in axis order."""
    mesh, group = _group(axis)
    if group is None:
        return x
    return _AllGather.apply(x, mesh, group, dim, mesh.axis_index(axis))


def local_chunk(x: torch.Tensor, axis: Axes, dim: int) -> torch.Tensor:
    """This rank's slice of ``x`` along ``dim`` when ``axis`` shards it
    (no communication); ``dim`` must divide evenly."""
    n = axis_size(axis)
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split over "
                         f"{n} shards of {axis}")
    return _LocalChunk.apply(x, n, axis_index(axis), dim)


def reduce_scatter(x: torch.Tensor, axis: Axes, dim: int) -> torch.Tensor:
    """Sum over ``axis`` and keep this rank's slice along ``dim``."""
    mesh, group = _group(axis)
    if group is None:
        return x
    n = dist.get_world_size(group)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split over "
                         f"{n} shards of {axis}")
    return _ReduceScatter.apply(x, mesh, group, dim, mesh.axis_index(axis))


def all_to_all(x: torch.Tensor, axis: Axes, split: int,
               concat: int) -> torch.Tensor:
    """Tiled all-to-all: ``x`` split along ``split`` into one chunk per
    rank of ``axis``, chunk j sent to rank j; the chunks received are
    concatenated along ``concat`` in rank order."""
    mesh, group = _group(axis)
    if group is None:
        return x
    n = dist.get_world_size(group)
    if x.shape[split] % n:
        raise ValueError(f"dim {split} of {tuple(x.shape)} does not split "
                         f"over {n} ranks")
    return _AllToAll.apply(x, mesh, group, split, concat)
