"""The sharded train state on the ("data", "model") mesh: which slice of
which leaf a rank stores, and the collectives that move between shards and
leaves.

``ShardLayout`` reads the parameters' placements (``sharding
.param_shardings`` / ``state_shardings``) on a live mesh: a leaf whose
placement puts a dim on "data" is stored as this rank's contiguous 1/n
slice of that dim, and one that puts a dim on "model" as its 1/m slice of
that dim (rank order, as ``jax.device_put`` lays out a ``NamedSharding``);
a leaf may be split on both, and is whole on an axis that places none of
its dims.  The optimizer moments mirror the parameters.

Three shapes of a leaf: its *stored* shape (both splits), its *compute*
shape (full over the data axis, this rank's slice over the model axis: what
``reshard_param`` hands the modules) and its *full* shape.  The gradient of
a data-sharded leaf reaches the step by one of two routes: through
autograd, ``reshard_param``'s backward has reduce-scattered it already (it
arrives at the stored shape); as a sum at the compute shape (the
book-keeping books and psg banks, ``bk_mixed`` and ``bk_mixed_taps``), it
is reduce-scattered here.  A leaf whole on the data axis has its gradient
all-reduced over it.  ``reduce_grads`` tells the routes apart by shape,
which differs on every data-sharded leaf when n > 1.  A model-sharded dim
is never reduced over "model": each model rank's slice is its own; a leaf
whole on the model axis comes out the same on every model rank (the
modules' collectives make its gradient complete there: ``copy_to_model``
where a whole tensor feeds split work, ``reshard.slice_whole`` where a
whole leaf does; the clipping engine gathers the book-keeping gradient
that split taps of such a leaf computed at their slices).  Under ``dp_only``
the model axis carries batch: the batch group is data x model, and every
gradient is also summed over the model axis; a batch that does not divide
over data x model splits over the data axis alone, as the JAX rule's longest
divisible prefix (``sharding.batch_shardings``) places it, and the model
ranks repeat its rows and sum nothing over the model axis.

A ``ShardLayout`` moves any tree between its full leaves and a rank's
slices under its placements, a serve state too (whose lanes may split
one dim over data x model, row-major); ``local_shape`` gives a leaf's
slice shape on any mesh.
"""
from __future__ import annotations

import math
from typing import Any, Optional

import torch

from repro_torch.launch.mesh import Mesh
from repro_torch.parallel import collectives
from repro_torch.parallel.sharding import Placement, axis_size, entry_names
from repro_torch.utils.tree import flatten_dict, unflatten_dict


def axis_dim(placement: Placement, axis: str) -> Optional[int]:
    """The dim ``placement`` puts on mesh axis ``axis`` (None: whole on it)."""
    for dim, entry in enumerate(placement):
        if axis in entry_names(entry):
            return dim
    return None


class ShardLayout:
    """The layout of a parameter tree on a live mesh.  ``batch_axes``: the
    axes the batch shards over (``mesh_axes(mesh, cfg)["batch"]``)."""

    def __init__(self, mesh: Mesh, param_placements: Any, batch_axes: tuple = ("data",)):
        self.mesh = mesh
        self.group = mesh.group("data")
        self.n = mesh.shape["data"]
        self.rank = mesh.coord("data")
        self.n_model = mesh.shape.get("model", 1)
        self.model_rank = mesh.coord("model")
        self.model_group = mesh.group("model") if self.n_model > 1 else None
        flat = flatten_dict(param_placements)
        self.dims = {path: axis_dim(p, "data") for path, p in flat.items()}
        self.model_dims = {path: axis_dim(p, "model") if self.n_model > 1 else None
                           for path, p in flat.items()}
        # the batch: over data, or (dp_only) over data x model, row-major
        self.batch_over_model = "model" in batch_axes and self.n_model > 1
        if self.batch_over_model:
            self.batch_group = mesh.group("batch")
            self.n_batch = self.n * self.n_model
            self.batch_rank = self.rank * self.n_model + self.model_rank
        else:
            self.batch_group, self.n_batch, self.batch_rank = self.group, self.n, self.rank

    # -- shapes ------------------------------------------------------------
    def compute_shape(self, path: str, local_shape) -> tuple:
        """The shape the modules compute with: full over the data axis."""
        shape = list(local_shape)
        d = self.dims[path]
        if d is not None:
            shape[d] *= self.n
        return tuple(shape)

    def full_shape(self, path: str, local_shape) -> tuple:
        shape = list(self.compute_shape(path, local_shape))
        d = self.model_dims[path]
        if d is not None:
            shape[d] *= self.n_model
        return tuple(shape)

    def compute_shapes(self, local: Any) -> dict[str, tuple]:
        return {path: self.compute_shape(path, x.shape)
                for path, x in flatten_dict(local).items()}

    def local(self, path: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's shard of a full-shape leaf (a copy)."""
        out = full
        for d, n, r in ((self.dims[path], self.n, self.rank),
                        (self.model_dims[path], self.n_model, self.model_rank)):
            if d is not None:
                size = out.shape[d] // n
                out = out.narrow(d, r * size, size)
        return out if out is full else out.clone()

    def local_bytes(self, tree: Any) -> int:
        return sum(x.numel() * x.element_size() for x in flatten_dict(tree).values())

    # -- trees -------------------------------------------------------------
    def shard(self, full_tree: Any) -> Any:
        """A parameter-shaped tree (params, or one optimizer moment) as this
        rank stores it."""
        return unflatten_dict({path: self.local(path, x)
                               for path, x in flatten_dict(full_tree).items()})

    def gather(self, local_tree: Any) -> Any:
        """The full leaves of a sharded tree: one all-gather per sharded dim
        of each leaf (model, then data: a dim split over data x model is
        row-major), in path order (the same on every rank)."""
        out = {}
        for path, x in flatten_dict(local_tree).items():
            if self.model_dims[path] is not None:
                x = collectives.all_gather_dim(x, self.model_dims[path], self.model_group)
            if self.dims[path] is not None:
                x = collectives.all_gather_dim(x, self.dims[path], self.group)
            out[path] = x
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
                g = collectives.all_reduce(g, self.group)
            elif self.n > 1 and tuple(g.shape) == tuple(flat_p[path].shape):
                pass  # reduce-scattered by reshard_param's backward
            elif tuple(g.shape) == self.compute_shape(path, flat_p[path].shape):
                g = collectives.reduce_scatter_dim(g, d, self.group)
            else:
                raise ValueError(f"gradient of {path}: {tuple(g.shape)}, stored "
                                 f"{tuple(flat_p[path].shape)} on {self.mesh.shape}")
            if self.batch_over_model:  # dp_only: the model ranks held other rows
                g = collectives.all_reduce(g, self.model_group)
            out[path] = g
        return unflatten_dict(out)

    def local_rows(self, batch: Any) -> Any:
        """This rank's rows of a global batch (dim 0 over the batch axes,
        row-major); a batch that does not divide over them raises: its rows
        would be counted on several ranks.  Under ``dp_only`` a batch that
        divides over data but not over data x model keeps data's rows
        (module docstring)."""
        flat = flatten_dict(batch)
        rows = {x.shape[0] if x.ndim else 0 for x in flat.values()}
        if self.batch_over_model and all(b % self.n_batch and not b % self.n for b in rows):
            self.batch_over_model = False
            self.batch_group, self.n_batch, self.batch_rank = self.group, self.n, self.rank
        out = {}
        for path, x in flat.items():
            if self.n_batch > 1 and (not x.ndim or x.shape[0] % self.n_batch):
                raise ValueError(
                    f"batch[{path!r}] of {tuple(x.shape)} does not divide over "
                    f"{self.n_batch} batch ranks")
            rows = x.shape[0] // self.n_batch
            out[path] = x.narrow(0, self.batch_rank * rows, rows)
        return unflatten_dict(out)

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every batch rank's rows of a per-sample tensor, in rank order."""
        return collectives.all_gather_dim(x, 0, self.batch_group)

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean over the batch ranks of one scalar per rank (model ranks
        that share rows hold the same scalar)."""
        return collectives.all_gather_dim(x.detach().reshape(1).float(), 0,
                                          self.batch_group).mean()


def local_shape(shape, placement: Placement, mesh: Mesh) -> tuple:
    """A leaf's shape on one rank of ``mesh`` (live or not) under
    ``placement``: each placed dim over the product of its axes."""
    return tuple(n // axis_size(mesh, tuple(a for a in entry_names(e) if a is not None))
                 for n, e in zip(shape, placement))


def sharded_fraction(layout: ShardLayout, local: Any) -> dict[str, float]:
    """{path: stored elements / full elements} of every leaf."""
    return {path: x.numel() / math.prod(layout.full_shape(path, x.shape))
            for path, x in flatten_dict(local).items()}
