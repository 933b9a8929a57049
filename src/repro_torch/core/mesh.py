"""Process meshes over ``torch.distributed`` (the port's ``jax.sharding.Mesh``).

The JAX package lays its sharded engine on a device mesh
(``repro.compat.make_mesh``) and reads, inside ``shard_map``, each axis's
size and this device's index on it (``compat.axis_size``,
``lax.axis_index``).  The port runs one process per shard instead: a
:class:`ProcessMesh` names the axes of the default process group, gives
this rank's coordinate on each, and holds one subgroup per axis for the
collectives along it.

Ranks are laid out row-major in axis order, as JAX orders the devices of
a mesh of fake CPU devices: on a ``(2, 4)`` ``("data", "model")`` mesh,
rank ``4 e + r`` holds ensemble block ``e`` and ring block ``r``.

The backend fits the tensors: ``nccl`` for a CUDA device, ``gloo`` for
``device="cpu"``.  A mesh whose process group has the other backend
raises; it never moves tensors between devices.  On the CPU::

    import torch.distributed as dist
    dist.init_process_group("gloo", init_method="file:///tmp/store",
                            rank=rank, world_size=8)
    mesh = make_mesh((2, 4), ("data", "model"), device="cpu")
"""
from __future__ import annotations

import itertools
import math
from typing import Sequence

import torch.distributed as dist

from ..device import resolve_device

_BACKEND = {"cuda": "nccl", "cpu": "gloo"}


class ProcessMesh:
    """Named axes over the ranks of the default process group.

    Attributes:
      axis_names: the axes, outermost first.
      shape: axis name -> size, in axis order (what ``plan_mesh_sweep``
        reads, as it reads ``jax.sharding.Mesh.shape``).
      device: where the mesh's tensors live (None for an abstract mesh).
      coords: axis name -> this rank's index on it (None when abstract).
    """

    def __init__(self, axis_shapes: Sequence[int], axis_names: Sequence[str],
                 *, device=None, coords=None, groups=None):
        if len(axis_shapes) != len(axis_names):
            raise ValueError(f"{len(axis_shapes)} axis sizes for "
                             f"{len(axis_names)} names")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"duplicate axis names: {tuple(axis_names)}")
        if any(int(n) < 1 for n in axis_shapes):
            raise ValueError(f"axis sizes must be >= 1, got "
                             f"{tuple(axis_shapes)}")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(n) for n in axis_shapes)))
        self.device = device
        self.coords = coords
        self._groups = groups

    @classmethod
    def abstract(cls, axis_shapes: Sequence[int],
                 axis_names: Sequence[str]) -> "ProcessMesh":
        """Sizes only, no process group: enough to plan, not to run
        (the counterpart of JAX's ``AbstractMesh``)."""
        return cls(axis_shapes, axis_names)

    @property
    def size(self) -> int:
        """Ranks in the mesh."""
        return math.prod(self.shape.values())

    @property
    def is_abstract(self) -> bool:
        return self._groups is None

    def group(self, axis: str):
        """The process group of this rank's line along ``axis``."""
        if self.is_abstract:
            raise ValueError("an abstract mesh has no process groups: build "
                             "one with make_mesh to run on it")
        return self._groups[axis]

    def rank_of(self, coords: dict) -> int:
        """Global rank at ``coords`` (row-major in axis order)."""
        r = 0
        for a in self.axis_names:
            r = r * self.shape[a] + int(coords[a])
        return r

    def coords_of(self, rank: int) -> dict:
        """Axis name -> index of global ``rank``."""
        out = {}
        for a in reversed(self.axis_names):
            rank, out[a] = divmod(rank, self.shape[a])
        return {a: out[a] for a in self.axis_names}

    def __repr__(self) -> str:
        dims = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        where = "abstract" if self.is_abstract else str(self.device)
        return f"ProcessMesh({dims}; {where})"


def make_mesh(axis_shapes: Sequence[int], axis_names: Sequence[str], *,
              device=None) -> ProcessMesh:
    """A mesh over the default process group (already initialised).

    Collective: every rank calls it, in the same order as any other
    ``make_mesh``, since it creates one subgroup per line of every axis.
    ``device=None`` is the current CUDA device (``nccl``); ``"cpu"``
    needs a ``gloo`` group.
    """
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed initialised "
                           "(init_process_group) on every rank")
    dev = resolve_device(device)
    backend = str(dist.get_backend()).lower()
    if backend != _BACKEND[dev.type]:
        raise ValueError(f"a mesh on {dev} needs the {_BACKEND[dev.type]!r} "
                         f"backend, the process group has {backend!r}")
    mesh = ProcessMesh(axis_shapes, axis_names)
    world = dist.get_world_size()
    if mesh.size != world:
        raise ValueError(f"mesh {tuple(mesh.shape.values())} has {mesh.size} "
                         f"ranks, the process group {world}")
    rank = dist.get_rank()
    groups = {}
    for axis in mesh.axis_names:
        others = [a for a in mesh.axis_names if a != axis]
        # every rank creates every line's group, in one order
        for fixed in itertools.product(*(range(mesh.shape[a])
                                         for a in others)):
            at = dict(zip(others, fixed))
            ranks = [mesh.rank_of({**at, axis: i})
                     for i in range(mesh.shape[axis])]
            g = dist.new_group(ranks)
            if rank in ranks:
                groups[axis] = g
    return ProcessMesh(axis_shapes, axis_names, device=dev,
                       coords=mesh.coords_of(rank), groups=groups)
