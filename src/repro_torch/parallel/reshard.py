"""Explicit FSDP weight gathering and the model axis's placements (port of
``parallel/reshard.py``).

Parameters are stored sharded over the fsdp axes (the data axis): that is
the optimizer-state win.  Compute sees them gathered, with the activations
batch-sharded.  ``reshard_param(w, axes, shape)`` all-gathers, over the
data axis, every dim of ``w`` that is stored sharded; its backward is the
reduce-scatter (sum) of the weight's gradient, FSDP's semantics, so the
gradient reaching the stored shard is already the fleet's sum.  Callers
cast to the compute dtype FIRST, so the gather moves the compute dtype
(bf16 under bf16 compute), as the JAX package prescribes.  A dim the rules
put on the model axis stays this rank's slice: the JAX docstring's plan
("drops the fsdp axes ... and keeps the tensor-parallel axes").

Where the JAX package reads a tensor's sharding from the array, a torch
tensor carries none: the caller gives ``shape``, the full shape of the
weight at this use, and the rules (``parallel.sharding``) say which of its
dims are stored over which axes; a dim that does not divide stays whole.

The model axis (tensor, expert and sequence parallelism), which GSPMD
writes for the JAX package, is written by hand in the modules (Megatron's
collectives, ``parallel.collectives``).  A module asks ``model_dim(axes,
shape)`` which dim of a weight is on "model" at this use, from the
resolved placement, and runs its column- or row-parallel form.
``shard_seq`` stores the layer carry as this rank's 1/model of the
sequence and ``unshard_seq`` gathers it back; ``shard_heads`` keeps this
rank's 1/model of a tensor's heads (Mamba's decay stream), ``whole_cols``
gathers the channels a column-parallel product split (a convolution's
output, a classifier's logits) and ``slice_whole`` gives this rank's slice
of a leaf stored whole (a norm gain over split channels), each with the
backward that leaves every model rank a complete gradient.  Ported: the
training step of the dense and MoE decoder LMs, the CNNs, the ViTs and
Mamba's heads (Jamba), and ``dp_only`` configurations, whose model axis
carries batch (``model_size`` is then 1: no module splits); and the
decoder LMs' prefill and decode steps, whose serve state is held at the
placements ``use_serve_placements`` declares: ``cache_seq_group`` is the
group a KV cache's rows are split over (context parallelism).

Active inside ``use_reshard_rules(mesh, cfg)`` on a live mesh; a no-op
otherwise.  The rules are process-wide (a stack), not a context variable
as in the JAX package: autograd runs a CUDA backward, and with it the
recomputation of a checkpointed layer, on a device thread of its own,
which would not see a context variable set on the step's thread.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch

from repro_torch.launch.mesh import Mesh
from repro_torch.parallel import collectives
from repro_torch.parallel.sharding import (
    _spec_for,
    axis_size,
    kv_rows_split,
    logical_rules,
    mesh_axes,
)

_STACK: list[tuple] = []  # (mesh, rules, fsdp axes, mesh_axes) of each enclosing context
_SERVE: list[tuple] = []  # of each enclosing serve step: (KV cache rows split, lanes)


def _state() -> Optional[tuple]:
    return _STACK[-1] if _STACK else None


@contextlib.contextmanager
def use_reshard_rules(mesh: Mesh, cfg=None):
    rules = logical_rules(mesh, cfg)
    axes = mesh_axes(mesh, cfg)
    _STACK.append((mesh, rules, set(axes["fsdp"]), axes))
    try:
        yield
    finally:
        _STACK.pop()


def active_mesh() -> Optional[Mesh]:
    """The mesh of the enclosing ``use_reshard_rules``, or None."""
    state = _state()
    return None if state is None else state[0]


def batch_axes() -> tuple[str, ...]:
    """The mesh axes the batch shards over in the enclosing context."""
    state = _state()
    return ("data",) if state is None else tuple(state[3]["batch"])


def model_size() -> int:
    """Ranks that split the model (tensor, expert, sequence parallelism):
    the model axis under a tensor-parallel configuration, else 1 (also
    under ``dp_only``, whose model axis carries batch)."""
    state = _state()
    if state is None or not state[3]["model"]:
        return 1
    return axis_size(state[0], state[3]["model"])


def model_group():
    """The model axis's process group where ``model_size() > 1``, else None."""
    return active_mesh().group("model") if model_size() > 1 else None


def model_coord() -> int:
    """This rank's coordinate on the model axis (0 without one)."""
    return active_mesh().coord("model") if model_size() > 1 else 0


def model_dim(axes: tuple, shape: tuple) -> Optional[int]:
    """The dim of a weight of full ``shape`` and logical ``axes`` that the
    resolved placement puts on the model axis at this use (None: the weight
    is whole on every model rank)."""
    if model_size() <= 1:
        return None
    mesh, rules = _state()[:2]
    for dim, entry in enumerate(_spec_for(tuple(shape), axes, rules, mesh)):
        if "model" in (entry if isinstance(entry, tuple) else (entry,)):
            return dim
    return None


@contextlib.contextmanager
def use_serve_placements(placements, lanes=None):
    """The serve state's placements (``sharding.local_serve_shardings``) for
    the prefill or decode step run inside: where they put a KV cache's rows
    on "model", the attention blocks run their context-parallel forms over
    ``cache_seq_group()``.  ``lanes``: the ``fsdp.ShardLayout`` the step's
    lanes split over (None: every lane on every rank), ``serve_lanes()``."""
    _SERVE.append((kv_rows_split(placements), lanes))
    try:
        yield
    finally:
        _SERVE.pop()


def cache_seq_group():
    """The process group a KV cache's rows (S) are split over in the
    enclosing serve step, or None (every row on every rank): the mesh's
    "model" axis, which is not always ``model_group()``: under ``dp_only``
    ``model_size()`` is 1 and the weights are whole, yet a long cache of a
    batch that does not divide still splits its rows there."""
    if not (_SERVE and _SERVE[-1][0]):
        return None
    return active_mesh().group("model")


def serve_lanes():
    """The layout of the lanes in the enclosing serve step where they split
    over the batch axes (each rank holds ``n_batch``-th of them, in rank
    order), or None: the MoE's global dispatch routes every rank's tokens
    together over it."""
    return _SERVE[-1][1] if _SERVE else None


def reshard_param(w: torch.Tensor, axes: tuple, shape: tuple) -> torch.Tensor:
    """``w`` with its fsdp-sharded dims gathered: its compute placement
    (full over the data axis, this rank's slice over the model axis)."""
    state = _state()
    if state is None:
        return w
    mesh, rules, fsdp, _ = state
    n_model = model_size()
    if mesh.shape.get("data", 1) <= 1 and n_model <= 1:
        return w
    if len(shape) != w.ndim:
        raise ValueError(f"reshard_param: {tuple(w.shape)} vs full shape {tuple(shape)}")
    spec = _spec_for(tuple(shape), axes, rules, mesh)
    for dim, (entry, full) in enumerate(zip(spec, shape)):
        names = tuple(a for a in (entry if isinstance(entry, tuple) else (entry,))
                      if a is not None)
        size = axis_size(mesh, tuple(a for a in names if a in fsdp))
        split = n_model if "model" in names else 1
        if w.shape[dim] * size * split != full:
            raise ValueError(
                f"reshard_param: dim {dim} of {tuple(w.shape)} (axes {axes}) is not the "
                f"stored placement {spec} of {tuple(shape)} on {mesh.shape}")
        if size > 1:
            w = collectives.gather_along_sum(w, dim, mesh.group("data"))
    return w


def shard_seq(x: torch.Tensor) -> torch.Tensor:
    """Sequence parallelism of a (B, T, d) layer carry: this rank's T/model
    slice (its backward all-gathers), where the model axis splits and T
    divides; the identity otherwise, as the JAX constraint."""
    n = model_size()
    if n <= 1 or x.ndim != 3 or x.shape[1] % n:
        return x
    return collectives.split_along(x, 1, model_group())


def unshard_seq(x: torch.Tensor, t: int) -> torch.Tensor:
    """The whole sequence of ``t`` positions from a carry ``shard_seq``
    sliced (its backward keeps this rank's slice); a whole carry as it is."""
    if x.shape[1] == t:
        return x
    return collectives.gather_along(x, 1, model_group())


def shard_heads(x: torch.Tensor, axis: int = 2) -> torch.Tensor:
    """This rank's 1/model of the heads (dim ``axis``) of a tensor every
    model rank holds whole (its backward all-gathers, so the whole tensor's
    gradient is complete on every rank), where the model axis splits and
    the heads divide; the identity otherwise, as the JAX constraint."""
    n = model_size()
    if n <= 1 or x.ndim <= axis or x.shape[axis] % n:
        return x
    return collectives.split_along(x, axis, model_group())


def whole_cols(x: torch.Tensor, full: int) -> torch.Tensor:
    """The ``full`` columns (last dim) of a column-parallel product's output
    of which this rank holds its slice, gathered (the backward keeps this
    rank's slice: every rank repeats what consumes them); a whole output as
    it is."""
    if x.shape[-1] == full:
        return x
    return collectives.gather_along(x, -1, model_group())


def slice_whole(w: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """This rank's 1/model of dim ``dim`` of a leaf stored whole on the model
    axis and used by this rank's slice of split work (Mamba's per-head
    ``D``, a norm gain over split channels): its backward all-gathers, so
    every model rank gets the leaf's complete gradient."""
    return collectives.split_along(w, dim, model_group())
