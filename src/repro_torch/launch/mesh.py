"""Meshes of ``torch.distributed`` ranks: the port of ``repro.launch.mesh``.

A :class:`Mesh` is an array of ranks, one process per position, with
named axes (``("data", "model")``) and the process group over its ranks.
Position ``i`` in row-major order is fabric logical device ``i`` of the
mesh (the contract the elastic sharded arena uses to map the fabric's
homes onto ranks).

- :func:`make_host_mesh`: every rank of the default group, laid out
  ``(world // model, model)`` through
  ``torch.distributed.device_mesh.init_device_mesh`` (the CPU tests, and
  the card's ranks);
- :func:`make_production_mesh`: the reference's TPU v5e pod shapes,
  ``(16, 16)`` or ``(2, 16, 16)`` with a ``pod`` axis, which need 256 or
  512 ranks;
- :func:`make_dry_mesh` and :func:`make_dry_production_mesh`: a
  :class:`DryMesh`, a mesh of any shape with one live position (default
  0) and no process group, for the dry run (``launch.dryrun``): its
  collectives are counted, not sent
  (``distributed.collectives.CountingComm``);
- :func:`survivor_mesh`: ``(n, 1)`` over an explicit rank list, its group
  a ``dist.new_group``. Every rank of the default group must call it with
  the same list at the same point, the ranks left out of it too
  (``new_group`` is collective); one group is made per survivor set and
  reused. A rank left out of a mesh stays alive and skips the mesh's work.

Each axis of a mesh has its lines: the ranks that differ only in that
axis's coordinate (a ``model`` line is one data position's tensor-parallel
ranks, a ``data`` line one model position's data-parallel ranks).
:meth:`Mesh.axis_mesh` is this rank's line as a 1-D mesh with its own
process group. :func:`make_mesh` makes every line's group of every axis,
in axis order and row-major line order, on every rank (``new_group`` is
collective); a line of one rank has no group and makes no collective call,
and a line of the whole mesh uses the mesh's group, so a survivor mesh
``(n, 1)`` makes none beyond its own.

``make_production_mesh`` is a function, not a module constant, so
importing this module touches no process group. Without an initialized
process group a mesh is one rank, position 0, with no group.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np
import torch.distributed as dist

_GROUPS: dict[tuple[int, ...], Any] = {}


class Mesh:
    """``devices``: an int array of ranks in the mesh's shape;
    ``axis_names``: one name an axis; ``group``: the process group over the
    ranks (None: the default group, or no process group at all);
    ``device_mesh``: the ``DeviceMesh`` it was built from, if any."""

    def __init__(self, devices, axis_names: Sequence[str], group=None,
                 device_mesh=None):
        self.devices = np.asarray(devices, np.int64)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{self.devices.ndim}-D devices, axes "
                             f"{self.axis_names}")
        self.group = group
        self.device_mesh = device_mesh
        self._axis_meshes: dict[str, Mesh] = {}

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, in axis order (as ``jax.sharding.Mesh``)."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def ranks(self) -> list[int]:
        return [int(r) for r in self.devices.reshape(-1)]

    def position(self, rank: Optional[int] = None) -> Optional[int]:
        """Row-major position of ``rank`` (default: this process's) in the
        mesh, or None when it is not a member."""
        if rank is None:
            rank = dist.get_rank() if dist.is_initialized() else 0
        ranks = self.ranks
        return ranks.index(int(rank)) if int(rank) in ranks else None

    def is_member(self, rank: Optional[int] = None) -> bool:
        return self.position(rank) is not None

    def coords(self, rank: Optional[int] = None) -> Optional[tuple]:
        """``rank``'s coordinate on each axis (default: this process's),
        or None when it is not a member."""
        pos = self.position(rank)
        if pos is None:
            return None
        return tuple(int(c) for c in np.unravel_index(pos,
                                                      self.devices.shape))

    def axis_position(self, name: str) -> int:
        """This rank's coordinate on axis ``name``."""
        return self.coords()[self.axis_names.index(name)]

    def axis_lines(self, name: str) -> list[list[int]]:
        """Every line of axis ``name``: the rank lists that vary along it
        with the other coordinates fixed, in row-major order."""
        a = self.axis_names.index(name)
        lines = np.moveaxis(self.devices, a, -1)
        return [[int(r) for r in line]
                for line in lines.reshape(-1, self.devices.shape[a])]

    def axis_mesh(self, name: str) -> "Mesh":
        """This rank's line of axis ``name`` as a 1-D mesh over its group
        (made by :func:`make_mesh`; none for a line of one rank)."""
        cached = self._axis_meshes.get(name)
        if cached is not None:
            return cached
        me = self.ranks[self.position()]
        line, = [ln for ln in self.axis_lines(name) if me in ln]
        if len(line) == 1:
            group = None
        elif sorted(line) == sorted(self.ranks):
            group = self.group
        else:
            group = _GROUPS[tuple(line)]
        sub = Mesh(np.asarray(line), (name,), group=group)
        self._axis_meshes[name] = sub
        return sub

    def data_line(self, names: Sequence[str]) -> "Mesh":
        """This rank's line of the one data axis in ``names`` (the
        :meth:`axis_mesh`); more than one data axis raises."""
        if len(names) != 1:
            raise ValueError(f"{self}: data axes {list(names)}, not one")
        return self.axis_mesh(names[0])

    def comm(self):
        """The collectives of this mesh for this rank
        (``distributed.collectives.MeshComm``)."""
        from repro_torch.distributed.collectives import MeshComm
        return MeshComm(self)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, ranks={self.ranks})"


class DryMesh(Mesh):
    """A mesh of ``devices`` (ranks ``0 .. n-1`` in its shape) whose one
    live position is ``live`` and which has no process group: this
    process runs that position's work, and every collective it calls is
    counted, not sent (:meth:`comm`). Its axis lines are dry meshes too,
    live at this position's place on them."""

    def __init__(self, devices, axis_names: Sequence[str], live: int = 0):
        super().__init__(devices, axis_names)
        if not 0 <= live < self.size:
            raise ValueError(f"position {live} of a {self.size}-rank mesh")
        self.live = int(live)

    def position(self, rank: Optional[int] = None) -> Optional[int]:
        if rank is None:
            return self.live
        return super().position(rank)

    def axis_mesh(self, name: str) -> "DryMesh":
        cached = self._axis_meshes.get(name)
        if cached is None:
            me = self.ranks[self.live]
            line, = [ln for ln in self.axis_lines(name) if me in ln]
            cached = DryMesh(np.asarray(line), (name,), line.index(me))
            self._axis_meshes[name] = cached
        return cached

    def data_line(self, names: Sequence[str]) -> "DryMesh":
        """This position's line of the data axes ``names``: one axis's
        line, or for several (the reference's multi-pod ``("pod",
        "data")``, whose pods are data parallelism alone) the ranks that
        differ from this position only on those axes (row-major over
        them), as one line of ``pod x data`` ranks."""
        if len(names) == 1:
            return self.axis_mesh(names[0])
        if not names:
            raise ValueError(f"{self}: no data axis")
        idx = [self.axis_names.index(a) for a in names]
        rest = [i for i in range(self.devices.ndim) if i not in idx]
        moved = np.moveaxis(self.devices, idx + rest, list(range(
            self.devices.ndim)))
        coords = self.coords()
        plane = moved[(slice(None),) * len(idx)
                      + tuple(coords[i] for i in rest)].reshape(-1)
        line = [int(r) for r in plane]
        return DryMesh(np.asarray(line), ("data",),
                       line.index(self.ranks[self.live]))

    def comm(self):
        """A ``distributed.collectives.CountingComm``: counted, not
        sent."""
        from repro_torch.distributed.collectives import CountingComm
        return CountingComm(self)

    def __repr__(self) -> str:
        return f"DryMesh({self.shape}, live={self.live})"


def make_dry_mesh(shape: Sequence[int], axes: Sequence[str],
                  position: int = 0) -> DryMesh:
    """A :class:`DryMesh` of ``shape`` live at row-major ``position``."""
    shape = tuple(int(s) for s in shape)
    return DryMesh(np.arange(int(np.prod(shape))).reshape(shape), axes,
                   position)


def make_dry_production_mesh(*, multi_pod: bool = False,
                             position: int = 0) -> DryMesh:
    """The reference's production mesh shape (:func:`make_production_mesh`)
    as a :class:`DryMesh` live at ``position``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_dry_mesh(shape, axes, position)


def _group(ranks: Sequence[int]):
    """The process group over ``ranks`` (collective on first use of a rank
    set: every rank of the default group calls it)."""
    if not dist.is_initialized():
        if list(ranks) != [0]:
            raise ValueError(f"ranks {list(ranks)} without a process group")
        return None
    key = tuple(int(r) for r in ranks)
    if key == tuple(range(dist.get_world_size())):
        return dist.group.WORLD
    if key not in _GROUPS:
        _GROUPS[key] = dist.new_group(list(key))
    return _GROUPS[key]


def make_mesh(shape: Sequence[int], axes: Sequence[str]) -> Mesh:
    """A mesh of ``shape`` over every rank of the default group, built with
    ``init_device_mesh`` (the group's size must be ``prod(shape)``)."""
    shape = tuple(int(s) for s in shape)
    n = int(np.prod(shape))
    if not dist.is_initialized():
        if n != 1:
            raise ValueError(f"a {shape} mesh needs {n} ranks and there is "
                             "no process group")
        return Mesh(np.zeros(shape, np.int64), axes)
    from torch.distributed.device_mesh import init_device_mesh
    dm = init_device_mesh("cpu", shape, mesh_dim_names=tuple(axes))
    mesh = Mesh(np.asarray(dm.mesh.tolist()).reshape(shape), axes,
                group=dist.group.WORLD, device_mesh=dm)
    _axis_groups(mesh)
    return mesh


def _axis_groups(mesh: Mesh) -> None:
    """Make the process group of every line of every axis of ``mesh``
    that has more than one rank and is not the whole mesh: in axis order,
    lines in row-major order, the same calls on every rank."""
    for name in mesh.axis_names:
        for line in mesh.axis_lines(name):
            if 1 < len(line) < mesh.size:
                _group(line)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_host_mesh(model: int = 1) -> Mesh:
    """Every rank of the default group as ``(world // model, model)``."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if n % model:
        raise ValueError(f"{n} ranks do not split into model={model}")
    return make_mesh((n // model, model), ("data", "model"))


def mesh_devices(mesh: Mesh) -> list[int]:
    """Row-major rank list of a mesh: position ``i`` here is fabric
    logical device ``i``."""
    return mesh.ranks


def survivor_mesh(devices) -> Mesh:
    """Mesh over an explicit surviving rank list: ``(n, 1)`` with axes
    ``("data", "model")`` (the model axis collapses on a shrink; the data
    axis carries the throughput). A full re-grow uses the base mesh."""
    ranks = np.asarray([int(d) for d in devices], np.int64)
    return Mesh(ranks.reshape(ranks.size, 1), ("data", "model"),
                group=_group(ranks.tolist()))
