"""Device meshes (port of ``launch/mesh.py``).

A ``Mesh`` is plain data: axis names, axis sizes, the number of processes
that own its devices and their device kinds.  The sharding rules
(``parallel.sharding``) evaluate on any mesh, also one that does not exist
here (the production ``(16, 16)`` pod), as the JAX package's rules do on an
``AbstractMesh``; a ``DeviceMesh`` would need the devices.  A *live* mesh
also holds the process group of each axis that has one and this process's
coordinate on it: ``make_host_mesh`` builds it from the initialised
``torch.distributed`` group.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import torch

from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]
    hosts: int = 1  # processes owning the mesh's devices (mesh_host_count)
    device_kinds: tuple[str, ...] = ()
    # live meshes only: the process group of each axis with more than one
    # member's worth of collectives, and this process's coordinates
    groups: Mapping[str, Any] = dataclasses.field(default_factory=dict, compare=False)
    coords: Mapping[str, int] = dataclasses.field(default_factory=dict, compare=False)

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"axes {self.axis_names} vs sizes {self.axis_sizes}")

    @property
    def shape(self) -> dict[str, int]:
        """{axis: size}, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def live(self) -> bool:
        """Whether collectives can run over this mesh's axes."""
        return bool(self.groups)

    def group(self, axis: str):
        try:
            return self.groups[axis]
        except KeyError:
            raise ValueError(f"mesh axis {axis!r} has no process group (live: {self.live})") \
                from None

    def coord(self, axis: str) -> int:
        return int(self.coords.get(axis, 0))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The abstract production shapes: ``(16, 16)`` ("data", "model"), or
    ``(2, 16, 16)`` with a "pod" axis in front."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_host_mesh(device: DeviceLike = None) -> Mesh:
    """Every process of the initialised process group as a ``(world, 1)``
    ("data", "model") mesh, or ``(1, 1)`` without one.  ``device`` is this
    process's device (None: the current GPU); the fleet's device kinds are
    gathered from every rank."""
    from repro_torch.tuner.plan import device_string

    dev = resolve_device(device)
    kind = device_string(dev)
    dist = torch.distributed
    if not (dist.is_available() and dist.is_initialized()):
        return Mesh(("data", "model"), (1, 1), hosts=1, device_kinds=(kind,))
    world, rank = dist.get_world_size(), dist.get_rank()
    kinds: list = [None] * world
    dist.all_gather_object(kinds, kind)
    return Mesh(
        ("data", "model"), (world, 1), hosts=world, device_kinds=tuple(sorted(set(kinds))),
        groups={"data": dist.group.WORLD}, coords={"data": rank, "model": 0},
    )


def mesh_host_count(mesh: Mesh) -> int:
    """Number of distinct processes owning devices of this mesh: the
    denominator of ``parallel.sharding.per_host_batch``, the share of the
    batch the memory certificates (the tuner's max-batch search and the
    mode re-certification) must be taken at."""
    return int(mesh.hosts)


def mesh_device_kinds(mesh: Mesh) -> tuple[str, ...]:
    """Sorted distinct device strings (``plan.device_string``) across the
    mesh; more than one means a mixed fleet, whose tuned plan needs the
    consensus tie-break (``repro_torch.tuner.consensus``)."""
    return tuple(sorted(set(mesh.device_kinds)))
