"""The port's device mesh: named axes over the ranks of ``torch.distributed``.

Stands for ``jax.make_mesh``, ``compat.set_mesh`` / ``get_abstract_mesh``
and ``lax.axis_index`` of the JAX package.  The reference writes one
program over global arrays and lets XLA place them on a mesh of devices;
the port runs one process per mesh device (a rank), which holds its shard
of every tensor and issues the collectives itself
(``repro_torch.distributed.collectives``).

Rank r sits at the row-major coordinates of r over the axes, in the order
the shape names them: JAX's device order, so a sequence offset, a vocab
range or an expert range lands on the rank that holds it there.  The mesh
makes one process subgroup for each non-empty tuple of its axes taken in
mesh order (every axis alone, ``("data", "model")``, ...), each group's
ranks in that row-major order, and fixes the collectives' backend once,
from where the ranks really compute: NCCL when every rank has a card of
its own, gloo otherwise (ranks that share a card, or CPU ranks).  On a
default group of the ``"fake"`` backend (``torch.testing``'s placeholder
ranks: every collective returns at once, with its output's shape) the
subgroups are fake too, and the mesh may compute on ``meta``: the dry run
(``launch.dryrun``) runs one rank's program on shapes alone.

``axis_size`` and ``divisible`` are the one size rule over a mesh's shape
(a dict of axis sizes): the specs read it on a shape alone, the model
code on the current mesh's.
"""
from __future__ import annotations

import contextlib
import itertools
import math
import socket
from typing import Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

Axes = Union[None, str, tuple[str, ...]]


def axis_size(axis: Axes, shape: Optional[dict[str, int]] = None) -> int:
    """Devices along an axis name, or the product over a tuple of names, on
    a mesh of ``shape`` (the current mesh's when None).  An axis the shape
    lacks, or no mesh at all, has size 1, as in the reference's
    ``axis_size``; the order of a tuple does not matter here."""
    if shape is None:
        mesh = current_mesh()
        shape = mesh.shape if mesh is not None else {}
    if axis is None:
        return 1
    names = (axis,) if isinstance(axis, str) else axis
    return math.prod(shape.get(a, 1) for a in names)


def divisible(dim: int, axis: Axes,
              shape: Optional[dict[str, int]] = None) -> bool:
    """Can ``dim`` be sharded over ``axis``: more than one device along it,
    and their count divides ``dim``."""
    if not axis:
        return False
    n = axis_size(axis, shape)
    return n > 1 and dim % n == 0


def placement(device: torch.device) -> tuple[str, int]:
    """Where a rank computing on ``device`` runs: its host, and the index of
    its card (-1 on the CPU)."""
    if device.type != "cuda":
        return socket.gethostname(), -1
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return socket.gethostname(), index


def choose_backend(placements: list[tuple[str, int]]) -> str:
    """NCCL when every rank computes on a card of its own (``placements``,
    one a rank), else gloo: ranks that share a card, or CPU ranks."""
    on_cards = all(index >= 0 for _, index in placements)
    if on_cards and len(set(placements)) == len(placements):
        return "nccl"
    return "gloo"


class Mesh:
    """Named axes of sizes ``shape`` over the initialised default group,
    whose size must be their product, for ranks computing on ``device``
    (the card unless the caller asks for the CPU, or ``meta`` over a fake
    group).  Collective: every rank must make the same meshes, in the same
    order."""

    def __init__(self, shape: dict[str, int],
                 device: torch.device | str = "cuda"):
        if not dist.is_initialized():
            raise RuntimeError("Mesh needs torch.distributed initialised")
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)
        self.size = math.prod(self.shape.values())
        if self.size != dist.get_world_size():
            raise ValueError(f"mesh {self.shape} has {self.size} devices, the "
                             f"group {dist.get_world_size()} ranks")
        self.device = resolve_device(device)
        self.rank = dist.get_rank()
        sizes = tuple(self.shape.values())
        self.coords = dict(zip(self.axis_names,
                               (int(c) for c in np.unravel_index(self.rank, sizes))))
        if dist.get_backend() == "fake":
            self.backend = "fake"
        else:
            places: list = [None] * self.size
            dist.all_gather_object(places, placement(self.device))
            self.backend = choose_backend(places)
        grid = np.arange(self.size).reshape(sizes)
        self._groups: dict[tuple[str, ...], dist.ProcessGroup] = {}
        self._axes_of: dict[int, tuple[str, ...]] = {}
        for n in range(1, len(sizes) + 1):
            for axes in itertools.combinations(self.axis_names, n):
                keep = [self.axis_names.index(a) for a in axes]
                rest = [i for i in range(len(sizes)) if i not in keep]
                # one group per coordinate of the other axes; its ranks,
                # sorted, are row-major over ``axes``
                flat = np.transpose(grid, rest + keep).reshape(
                    -1, math.prod(sizes[i] for i in keep))
                for ranks in flat.tolist():
                    group = dist.new_group(ranks, backend=self.backend)
                    if self.rank in ranks:
                        self._groups[axes] = group
                        self._axes_of[id(group)] = axes
        if self.rank == 0 and self.backend != "fake":
            share = "a GPU each" if self.backend == "nccl" else (
                f"{self.size} ranks on {self.device}" if self.device.type == "cuda"
                else f"{self.size} CPU ranks")
            print(f"[mesh] {self.shape}: collectives over {self.backend} "
                  f"({share})", flush=True)

    def axes(self, axis: Axes) -> tuple[str, ...]:
        """``axis`` (a name or a tuple of names) as a tuple of the mesh's
        axes of size > 1; an axis the mesh lacks has size 1.  A tuple must
        follow the mesh's order, which fixes the ranks' row-major order."""
        if axis is None:
            return ()
        names = (axis,) if isinstance(axis, str) else tuple(axis)
        order = [self.axis_names.index(a) for a in names if a in self.shape]
        if order != sorted(order):
            raise ValueError(f"axes {names} are not in the mesh's order "
                             f"{self.axis_names}")
        return tuple(a for a in names if self.shape.get(a, 1) > 1)

    def axis_index(self, axis: Axes) -> int:
        """This rank's index along ``axis``: row-major over a tuple."""
        idx = 0
        for a in self.axes(axis):
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def group(self, axis: Axes) -> Optional[dist.ProcessGroup]:
        """The subgroup of the ranks that differ only along ``axis`` (None
        when its size is 1)."""
        axes = self.axes(axis)
        return self._groups[axes] if axes else None

    def group_axes(self, group: dist.ProcessGroup) -> tuple[str, ...]:
        """The axes of one of this rank's subgroups."""
        return self._axes_of[id(group)]

    def stages(self, x: torch.Tensor) -> bool:
        """Whether a collective moves ``x`` through host memory: a CUDA
        tensor on a gloo mesh."""
        return self.backend == "gloo" and x.device.type == "cuda"


_STACK: list[Mesh] = []


@contextlib.contextmanager
def set_mesh(mesh: Mesh):
    """Make ``mesh`` the current one inside the block."""
    _STACK.append(mesh)
    try:
        yield mesh
    finally:
        _STACK.pop()


def current_mesh() -> Optional[Mesh]:
    """The mesh of the innermost ``set_mesh`` block, or None outside."""
    return _STACK[-1] if _STACK else None
