"""Device meshes over the world: the port's counterpart of
``paddle_tpu/parallel/mesh.py``.

A ``Mesh`` names the axes of the world with the JAX package's names
(``dp``, ``ep``, ...). Over a formed world it wraps a
``torch.distributed.device_mesh.DeviceMesh`` of the ranks (one process a
device, ranks in row-major order over the axes) and holds one process
group per axis. Process groups are created collectively: every rank
must create them in the same order, so a mesh builds all of its groups
when it is constructed, never lazily inside an op, and ``make_mesh``
returns the same mesh for the same axes while the world lives. Without
a world only a mesh of one device exists; its groups are None, and the
collectives over them are identities.

``RingRegistry`` maps a collective op's ``ring_id`` to a mesh axis
(the reference's ``c_comm_init`` per ring); ``ring_group`` resolves a
ring to a process group: its axis on the current mesh, else the whole
world (every ring rides the one world, as the JAX package's
multi-process path does), else None.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import numpy as np
import torch

__all__ = ["RingRegistry", "ring_registry", "Mesh", "MeshContext",
           "make_mesh", "get_mesh", "mesh_guard", "ring_group",
           "world_group"]


class RingRegistry:
    """ring_id -> mesh axis name (reference c_comm_init per ring)."""

    def __init__(self):
        self._rings: Dict[int, str] = {}

    def register(self, ring_id: int, axis_name: str):
        self._rings[int(ring_id)] = axis_name

    def axis(self, ring_id: int) -> Optional[str]:
        return self._rings.get(int(ring_id))

    def clear(self):
        self._rings.clear()


ring_registry = RingRegistry()


def _dist():
    dist = torch.distributed
    return dist if dist.is_available() and dist.is_initialized() else None


def world_group():
    """The world's process group, None without a world."""
    dist = _dist()
    return dist.group.WORLD if dist is not None else None


class Mesh:
    """Named axes over the world's ranks (see the module docstring).

    ``shape``: {axis: size} in axis order; ``coords``: this rank's
    index on each axis; ``group(axis)``: the axis's process group (the
    ranks that differ from this one only on that axis), None without a
    world; ``device_mesh``: the ``DeviceMesh`` (None without a
    world)."""

    def __init__(self, axes: Dict[str, int]):
        self.shape = {str(k): int(v) for k, v in dict(axes).items()}
        self.axis_names = tuple(self.shape)
        dims = tuple(self.shape.values())
        total = int(np.prod(dims)) if dims else 1
        dist = _dist()
        world = dist.get_world_size() if dist is not None else 1
        if total != world:
            raise ValueError(
                f"mesh {self.shape} needs {total} processes, the world has "
                f"{world} (one process a device: start the world with "
                "python -m paddle_tpu_torch.distributed.launch "
                f"--nproc_per_node {total})")
        rank = dist.get_rank() if dist is not None else 0
        self.devices = np.arange(total).reshape(dims)
        self.coords = {a: int(c) for a, c in zip(
            self.axis_names, np.unravel_index(rank, dims))}
        self.rank = rank
        self._groups: Dict[str, object] = {}
        self.device_mesh = None
        if dist is not None:
            from torch.distributed.device_mesh import DeviceMesh

            device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
            self.device_mesh = DeviceMesh(
                device_type, torch.arange(total).reshape(dims),
                mesh_dim_names=self.axis_names)
            for a in self.axis_names:
                self._groups[a] = self.device_mesh.get_group(a)

    def axis_size(self, axis: str) -> int:
        return int(self.shape.get(axis, 1))

    def coord(self, axis: str) -> int:
        return int(self.coords.get(axis, 0))

    def group(self, axis: str):
        return self._groups.get(axis)

    def __repr__(self):
        return f"Mesh({self.shape}, rank={self.rank})"


_MESHES: Dict[tuple, tuple] = {}


def make_mesh(axis_shapes: Dict[str, int], devices=None) -> Mesh:
    """The mesh of ``axis_shapes`` ({'dp': 2, 'ep': 2}) over the world:
    one per (axes, world), built on first use and reused, so a script
    that compiles many programs creates each axis's groups once.
    ``devices`` is accepted for the JAX package's signature; a process
    drives one device."""
    world = world_group()
    key = (tuple((str(k), int(v)) for k, v in dict(axis_shapes).items()),
           id(world))
    hit = _MESHES.get(key)
    if hit is not None and hit[0] is world:
        return hit[1]
    mesh = Mesh(axis_shapes)
    _MESHES[key] = (world, mesh)
    return mesh


def clear_meshes() -> None:
    """Forget the cached meshes (after the world is destroyed)."""
    _MESHES.clear()


class MeshContext:
    def __init__(self, mesh):
        self.mesh = mesh


_current_mesh = MeshContext(None)


def get_mesh():
    return _current_mesh.mesh


@contextlib.contextmanager
def mesh_guard(mesh):
    global _current_mesh
    prev = _current_mesh
    _current_mesh = MeshContext(mesh)
    try:
        yield mesh
    finally:
        _current_mesh = prev


def ring_group(ring_id: int, mesh: Optional[Mesh] = None):
    """The process group a collective op's ``ring_id`` runs over (see
    the module docstring); None means the op is an identity."""
    axis = ring_registry.axis(ring_id)
    mesh = mesh if mesh is not None else get_mesh()
    if axis is not None and mesh is not None and axis in mesh.shape:
        return mesh.group(axis)
    return world_group()
