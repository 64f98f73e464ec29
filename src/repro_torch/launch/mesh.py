"""Meshes: the host mesh of a run and the production meshes of the dry run.

The port's counterpart of ``repro/launch/mesh.py``.  A :class:`Mesh` names
its axes and their sizes and holds the devices of this process.  When the
default process group's world size equals the mesh's size, it also holds
a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks (row-major,
rank ``r`` at the coordinates ``np.unravel_index(r, shape)``), so that an
axis, or several, has a process group (:meth:`Mesh.get_group`).  A mesh
without one describes a layout and starts nothing: the production meshes
of the dry run (:func:`make_production_mesh`) are such.
"""
from __future__ import annotations

import contextlib
from math import prod

import numpy as np
import torch

__all__ = ["Mesh", "Sharding", "make_host_mesh", "make_production_mesh",
           "use_mesh", "current_mesh"]


class Mesh:
    """Named axes over ``shape`` ranks; ``devices`` are this process's."""

    def __init__(self, shape, axis_names, devices=(), device_mesh=None):
        self.dims = tuple(int(s) for s in shape)
        self.axis_names = tuple(axis_names)
        if len(self.dims) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.dims} vs axes "
                             f"{self.axis_names}")
        self.devices = [torch.device(d) for d in devices]
        self.device_mesh = device_mesh
        self._groups: dict = {}

    @property
    def shape(self) -> dict:
        """Axis name -> size, in mesh order (jax's ``Mesh.shape``)."""
        return dict(zip(self.axis_names, self.dims))

    @property
    def size(self) -> int:
        return prod(self.dims)

    @property
    def device(self) -> torch.device:
        """This process's device (the first of :attr:`devices`)."""
        return self.devices[0]

    @property
    def rank(self) -> int:
        """This process's rank in the mesh (0 without a process group)."""
        if self.device_mesh is None:
            return 0
        import torch.distributed as dist

        return dist.get_rank()

    def coords(self) -> dict:
        """Axis name -> this process's coordinate on it."""
        return dict(zip(self.axis_names,
                        (int(c) for c in np.unravel_index(self.rank,
                                                          self.dims))))

    def axis_size(self, axes) -> int:
        """Ranks along ``axes`` (a name, a tuple of names, or None: 1)."""
        if axes is None:
            return 1
        names = axes if isinstance(axes, tuple) else (axes,)
        return prod(self.shape[a] for a in names)

    def axis_index(self, axes) -> int:
        """This process's index along ``axes`` (row-major over them)."""
        if axes is None:
            return 0
        names = axes if isinstance(axes, tuple) else (axes,)
        c = self.coords()
        idx = 0
        for a in names:
            idx = idx * self.shape[a] + c[a]
        return idx

    def get_group(self, axes):
        """The process group along ``axes`` (a name or a tuple of names,
        in mesh order): the default group where they span the whole mesh,
        one axis's group of the ``DeviceMesh`` otherwise.  Needs a process
        group of the mesh's size."""
        import torch.distributed as dist

        if self.device_mesh is None:
            raise RuntimeError(
                "this mesh has no process group: initialise the default "
                "group with a world size equal to the mesh's "
                f"({self.size}) before making the mesh")
        names = tuple(a for a in (axes if isinstance(axes, tuple)
                                  else (axes,)) if self.shape[a] > 1)
        if self.axis_size(names) == self.size:
            return dist.group.WORLD
        if len(names) == 1:
            return self.device_mesh.get_group(names[0])
        if not names:  # a single rank: this one's group along an axis of 1
            return self.device_mesh.get_group(next(
                a for a in self.axis_names if self.shape[a] == 1))
        if names not in self._groups:
            self._groups[names] = self.device_mesh[names]._flatten() \
                .get_group()
        return self._groups[names]

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, devices={self.devices}, "
                f"process_group={self.device_mesh is not None})")


class Sharding:
    """Where an array of a step lives on a mesh: ``spec`` holds, for each
    dimension of the array, the mesh axis it is split over (a name, a
    tuple of names in mesh order, or None: whole), as the reference's
    ``NamedSharding(mesh, PartitionSpec(*spec))``."""

    def __init__(self, mesh: Mesh, spec=()):
        self.mesh = mesh
        self.spec = tuple(spec)

    def dim_axes(self, dim: int) -> tuple:
        """The mesh axes dimension ``dim`` is split over."""
        if dim >= len(self.spec) or self.spec[dim] is None:
            return ()
        a = self.spec[dim]
        return a if isinstance(a, tuple) else (a,)

    @property
    def frac(self) -> int:
        """How many ways the array is split (the reference's
        ``_shard_frac``)."""
        return prod(self.mesh.axis_size(self.dim_axes(d))
                    for d in range(len(self.spec)))

    def __eq__(self, other) -> bool:
        return isinstance(other, Sharding) and other.mesh is self.mesh \
            and other.spec == self.spec

    def __repr__(self) -> str:
        return f"Sharding({self.spec})"


def _device_mesh(shape, axis_names, device: torch.device):
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh(device.type, torch.arange(prod(shape)).reshape(shape),
                      mesh_dim_names=tuple(axis_names))


def make_host_mesh(max_data: int | None = 1, device=None) -> Mesh:
    """A ``(data, model)`` mesh of this run with a ``model`` axis of 1.

    Without a default process group it is one rank on ``device``
    (``None``: cuda:0, raising without a GPU; ``"cpu"`` for the CPU).
    With one of world size W (1 included) its data axis takes
    ``min(max_data, W)`` ranks (``None``: all W); when that is all of them
    the mesh holds a ``DeviceMesh`` over the group, and a rank's default
    device is ``cuda:(rank % visible cards)``."""
    import torch.distributed as dist

    from ..core.engine import resolve_device

    grouped = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if grouped else 1
    data = world if max_data is None else max(1, min(int(max_data), world))
    if device is None and grouped and torch.cuda.is_available():
        device = torch.device("cuda", dist.get_rank()
                              % torch.cuda.device_count())
    device = resolve_device(device)
    shape, axes = (data, 1), ("data", "model")
    dm = _device_mesh(shape, axes, device) if grouped and data == world \
        else None
    return Mesh(shape, axes, [device], dm)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The 256-chip pod mesh ``(data, model)`` = (16, 16), or the 512-chip
    two-pod mesh ``(pod, data, model)`` = (2, 16, 16): a layout for the
    dry run, with no devices and no process group."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes)


_ACTIVE: list = []


@contextlib.contextmanager
def use_mesh(mesh: Mesh):
    """Make ``mesh`` the active mesh for a ``with`` block
    (:func:`current_mesh`), as the reference's ``use_mesh`` does."""
    _ACTIVE.append(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.pop()


def current_mesh() -> Mesh | None:
    """The innermost mesh made active by :func:`use_mesh`, or None."""
    return _ACTIVE[-1] if _ACTIVE else None
