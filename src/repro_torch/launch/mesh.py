"""Device meshes (port of ``launch/mesh.py``).

A ``Mesh`` is plain data: axis names, axis sizes, the number of processes
that own its devices and their device kinds.  The sharding rules
(``parallel.sharding``) evaluate on any mesh, also one that does not exist
here (the production ``(16, 16)`` pod), as the JAX package's rules do on an
``AbstractMesh``; a ``DeviceMesh`` would need the devices.  A *live* mesh
also holds the process group of each axis that has one and this process's
coordinate on it: ``make_mesh`` builds one of any ``(data, model)`` shape
from the initialised ``torch.distributed`` group, ``make_host_mesh`` the
``(world, 1)`` one the train CLI runs (the JAX CLI's ``make_host_mesh`` is
``(n, 1)`` too).

Rank ``r`` of a ``(d, m)`` mesh sits at ``(r // m, r % m)``, as
``jax.make_mesh`` lays the devices out row-major: the "model" group holds
``m`` consecutive ranks, the "data" group the ranks with the same model
coordinate, and "batch" every rank (the batch group of a ``dp_only``
configuration, whose batch spans both axes).

The dry run (``launch.dryrun``) builds a live mesh of a production shape
over a ``fake`` process group (``fake_process_group``: one process as rank
0 of 256 or 512, collectives that move nothing).  ``live_shape`` gives its
``(data, model)`` shape: the ``(2, 16, 16)`` mesh's "pod" axis folds into
"data", a data group of the 32 ranks of pod x data.  The rules put batch
and FSDP on ("pod", "data") together, which on the folded mesh is "data"
over the same 32 ranks; a placement would differ only where a dim divides
by the pod axis but not by pod x data (the rules then name "pod" alone),
which no leaf of the registry's does.  The dry run checks that, cell by
cell, rather than building groups that follow such a placement.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Iterator, Mapping

import torch

from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]
    hosts: int = 1  # processes owning the mesh's devices (mesh_host_count)
    device_kinds: tuple[str, ...] = ()
    # live meshes only: the process group of each axis ("data", "model",
    # and "batch", all of them), and this process's coordinates
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


def live_shape(mesh: Mesh) -> tuple[int, int]:
    """The ``(data, model)`` shape a live mesh of ``mesh`` takes: a "pod"
    axis folded into "data" (module docstring)."""
    shape = mesh.shape
    return shape.get("pod", 1) * shape.get("data", 1), shape.get("model", 1)


@contextlib.contextmanager
def fake_process_group(world: int, rank: int = 0) -> Iterator[None]:
    """This process as ``rank`` of a ``fake`` process group of ``world``
    ranks (``torch.testing._internal.distributed.fake_pg``): groups and
    collectives take every call and move no byte, so one process can run
    one rank's step of a large fleet.  Destroyed on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist = torch.distributed
    if dist.is_initialized():
        raise RuntimeError("a process group is initialised already: the fake one would "
                           "replace it")
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_host_mesh(device: DeviceLike = None) -> Mesh:
    """Every process of the initialised process group as a ``(world, 1)``
    ("data", "model") mesh, or ``(1, 1)`` without one.  ``device`` is this
    process's device (None: the current GPU); the fleet's device kinds are
    gathered from every rank."""
    dist = torch.distributed
    if not (dist.is_available() and dist.is_initialized()):
        from repro_torch.tuner.plan import device_string

        return Mesh(("data", "model"), (1, 1), hosts=1,
                    device_kinds=(device_string(resolve_device(device)),))
    return make_mesh((dist.get_world_size(), 1), device)


def make_mesh(shape: tuple[int, int], device: DeviceLike = None) -> Mesh:
    """A live ``(data, model)`` mesh of ``shape`` over every process of the
    initialised process group (the JAX package's ``_make_mesh(shape,
    ("data", "model"))``): one process a device, rank ``r`` at ``(r // m,
    r % m)``.  Every rank must call it (it creates the axes' groups)."""
    from repro_torch.tuner.plan import device_string

    dist = torch.distributed
    n_data, n_model = (int(s) for s in shape)
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_data * n_model != world:
        raise ValueError(f"mesh {shape} over {world} processes")
    kinds: list = [None] * world
    dist.all_gather_object(kinds, device_string(resolve_device(device)))
    groups = {"batch": dist.group.WORLD}
    if n_model == 1:
        groups["data"] = dist.group.WORLD
    else:  # every rank creates every group, in the same order
        for i in range(n_data):
            g = dist.new_group([i * n_model + j for j in range(n_model)])
            if i == rank // n_model:
                groups["model"] = g
        for j in range(n_model):
            g = dist.new_group([i * n_model + j for i in range(n_data)])
            if j == rank % n_model:
                groups["data"] = g
    return Mesh(
        ("data", "model"), (n_data, n_model), hosts=world,
        device_kinds=tuple(sorted(set(kinds))), groups=groups,
        coords={"data": rank // n_model, "model": rank % n_model},
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
