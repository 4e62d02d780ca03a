"""The sharded train state on the data axis: which rows of which leaf a
rank stores, and the collectives that move between shards and leaves.

``ShardLayout`` reads the parameters' placements (``sharding
.param_shardings`` / ``state_shardings``) on a live mesh: a leaf whose
placement puts a dim on "data" is stored as this rank's contiguous
1/n slice of that dim (rank order, as ``jax.device_put`` lays out a
``NamedSharding``); every other leaf is stored whole on every rank.  The
optimizer moments mirror the parameters.  The model axis must be one
(``reshard.ModelAxisNotPorted`` otherwise).

The gradient of a sharded leaf reaches the step by one of two routes:
through autograd, ``reshard_param``'s backward has reduce-scattered it
already (it arrives at the shard's shape); as a full-shape sum (the
book-keeping books and psg banks, ``bk_mixed`` and ``bk_mixed_taps``), it
is reduce-scattered here.  A whole leaf's gradient is all-reduced.  So
``reduce_grads`` tells the routes apart by shape, which differs on every
sharded leaf when n > 1; with one rank every gradient is full-shape and
goes through a one-rank collective.
"""
from __future__ import annotations

import math
from typing import Any, Optional

import torch

from repro_torch.launch.mesh import Mesh
from repro_torch.parallel import collectives
from repro_torch.parallel.reshard import ModelAxisNotPorted
from repro_torch.parallel.sharding import Placement, batch_shardings
from repro_torch.utils.tree import flatten_dict, unflatten_dict


def data_dim(placement: Placement, mesh: Mesh) -> Optional[int]:
    """The dim ``placement`` puts on the data axis (None: stored whole)."""
    out = None
    for dim, entry in enumerate(placement):
        names = entry if isinstance(entry, tuple) else (entry,)
        for a in names:
            if a is None or a == "data":
                continue
            if mesh.shape[a] > 1:
                raise ModelAxisNotPorted(f"placement {placement} on mesh {mesh.shape}")
        if "data" in names:
            out = dim
    return out


class ShardLayout:
    """The data-axis layout of a parameter tree on a live mesh."""

    def __init__(self, mesh: Mesh, param_placements: Any):
        self.mesh = mesh
        self.group = mesh.group("data")
        self.n = mesh.shape["data"]
        self.rank = mesh.coord("data")
        self.dims = {path: data_dim(p, mesh)
                     for path, p in flatten_dict(param_placements).items()}

    # -- shapes ------------------------------------------------------------
    def full_shape(self, path: str, local_shape) -> tuple:
        shape = list(local_shape)
        d = self.dims[path]
        if d is not None:
            shape[d] *= self.n
        return tuple(shape)

    def full_shapes(self, local: Any) -> dict[str, tuple]:
        return {path: self.full_shape(path, x.shape) for path, x in flatten_dict(local).items()}

    def local(self, path: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's shard of a full-shape leaf (a copy)."""
        d = self.dims[path]
        if d is None:
            return full
        size = full.shape[d] // self.n
        return full.narrow(d, self.rank * size, size).clone()

    def local_bytes(self, tree: Any) -> int:
        return sum(x.numel() * x.element_size() for x in flatten_dict(tree).values())

    # -- trees -------------------------------------------------------------
    def shard(self, full_tree: Any) -> Any:
        """A parameter-shaped tree (params, or one optimizer moment) as this
        rank stores it."""
        return unflatten_dict({path: self.local(path, x)
                               for path, x in flatten_dict(full_tree).items()})

    def gather(self, local_tree: Any) -> Any:
        """The full leaves of a parameter-shaped tree: one all-gather per
        sharded leaf, in path order (the same on every rank)."""
        out = {}
        for path, x in flatten_dict(local_tree).items():
            d = self.dims[path]
            out[path] = x if d is None else collectives.all_gather_dim(x, d, self.group)
        return unflatten_dict(out)

    def shard_state(self, state: dict) -> dict:
        """Params and optimizer moments sharded; the rest as it is."""
        out = dict(state)
        out["params"] = self.shard(state["params"])
        out["opt"] = {k: self.shard(v) for k, v in state["opt"].items()}
        return out

    def gather_state(self, state: dict) -> dict:
        out = dict(state)
        out["params"] = self.gather(state["params"])
        out["opt"] = {k: self.gather(v) for k, v in state["opt"].items()}
        return out

    # -- the step ----------------------------------------------------------
    def reduce_grads(self, grads: Any, params: Any) -> Any:
        """The fleet's gradient sum at each stored leaf's shape (see the
        module docstring for the two routes)."""
        flat_p = flatten_dict(params)
        out = {}
        for path, g in flatten_dict(grads).items():
            d = self.dims[path]
            if d is None:
                out[path] = collectives.all_reduce(g, self.group)
            elif self.n > 1 and tuple(g.shape) == tuple(flat_p[path].shape):
                out[path] = g  # reduce-scattered by reshard_param's backward
            else:
                out[path] = collectives.reduce_scatter_dim(g, d, self.group)
        return unflatten_dict(out)

    def local_rows(self, batch: Any) -> Any:
        """This rank's rows of a global batch (dim 0 over the data axis, as
        ``batch_shardings`` places it); a batch that does not divide over
        the data axis raises: its rows would be counted on every rank."""
        places = flatten_dict(batch_shardings(batch, self.mesh))
        out = {}
        for path, x in flatten_dict(batch).items():
            if self.n > 1 and "data" not in _names(places[path]):
                raise ValueError(
                    f"batch[{path!r}] of {tuple(x.shape)} does not divide over "
                    f"{self.n} data ranks")
            rows = x.shape[0] // self.n
            out[path] = x.narrow(0, self.rank * rows, rows)
        return unflatten_dict(out)

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's rows of a per-sample tensor, in rank order."""
        return collectives.all_gather_dim(x, 0, self.group)

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean over the ranks of one scalar per rank."""
        return collectives.all_gather_dim(x.detach().reshape(1).float(), 0, self.group).mean()


def _names(entry_tuple: tuple) -> tuple:
    out: list = []
    for e in entry_tuple:
        out.extend(e if isinstance(e, tuple) else (e,))
    return tuple(out)


def sharded_fraction(layout: ShardLayout, local: Any) -> dict[str, float]:
    """{path: stored elements / full elements} of every leaf."""
    return {path: x.numel() / math.prod(layout.full_shape(path, x.shape))
            for path, x in flatten_dict(local).items()}
