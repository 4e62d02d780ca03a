"""Explicit FSDP weight gathering (port of ``parallel/reshard.py``).

Parameters are stored sharded over the fsdp axes (the data axis): that is
the optimizer-state win.  Compute sees them gathered, with the activations
batch-sharded.  ``reshard_param(w, axes, shape)`` all-gathers, over the
data axis, every dim of ``w`` that is stored sharded; its backward is the
reduce-scatter (sum) of the weight's gradient, FSDP's semantics, so the
gradient reaching the stored shard is already the fleet's sum.  Callers
cast to the compute dtype FIRST, so the gather moves the compute dtype
(bf16 under bf16 compute), as the JAX package prescribes.

Where the JAX package reads a tensor's sharding from the array, a torch
tensor carries none: the caller gives ``shape``, the full shape of the
weight at this use, and a dim is gathered where the stored tensor is
smaller.  Which dims may be sharded comes from the rules
(``parallel.sharding``): a dim the rules do not put on the data axis, or
one that does not divide, must arrive whole.

Active inside ``use_reshard_rules(mesh, cfg)`` on a live mesh whose data
axis has more than one rank; a no-op otherwise.  The rules are process-wide
(a stack), not a context variable as in the JAX package: autograd runs a
CUDA backward, and with it the recomputation of a checkpointed layer, on a
device thread of its own, which would not see a context variable set on
the step's thread.  The model axis (tensor,
expert and sequence parallelism) comes with a later slice: where it is
larger than one, ``reshard_param``, ``shard_seq`` and ``shard_heads``
raise ``ModelAxisNotPorted``; at one they are identities.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch

from repro_torch.launch.mesh import Mesh
from repro_torch.parallel import collectives
from repro_torch.parallel.sharding import _spec_for, axis_size, logical_rules, mesh_axes

_STACK: list[tuple] = []  # (mesh, rules, fsdp axes) of each enclosing context


def _state() -> Optional[tuple]:
    return _STACK[-1] if _STACK else None


class ModelAxisNotPorted(NotImplementedError):
    """A mesh whose model axis is larger than one: tensor, expert and
    sequence parallelism are not in the port yet."""


@contextlib.contextmanager
def use_reshard_rules(mesh: Mesh, cfg=None):
    rules = logical_rules(mesh, cfg)
    fsdp = set(mesh_axes(mesh)["fsdp"])
    _STACK.append((mesh, rules, fsdp))
    try:
        yield
    finally:
        _STACK.pop()


def active_mesh() -> Optional[Mesh]:
    """The mesh of the enclosing ``use_reshard_rules``, or None."""
    state = _state()
    return None if state is None else state[0]


def data_size() -> int:
    """Ranks on the data axis of the enclosing context (1 outside one)."""
    mesh = active_mesh()
    return 1 if mesh is None else mesh.shape.get("data", 1)


def _model_size(mesh: Mesh) -> int:
    return mesh.shape.get("model", 1)


class _GatherDim(torch.autograd.Function):
    """All-gather along ``dim`` forward, reduce-scatter (sum) backward."""

    @staticmethod
    def forward(ctx, w, dim: int, group):
        ctx.dim, ctx.group = dim, group
        return collectives.all_gather_dim(w, dim, group)

    @staticmethod
    def backward(ctx, g):
        return collectives.reduce_scatter_dim(g, ctx.dim, ctx.group), None, None


def reshard_param(w: torch.Tensor, axes: tuple, shape: tuple) -> torch.Tensor:
    """``w`` with its fsdp-sharded dims gathered: its compute placement."""
    state = _state()
    if state is None:
        return w
    mesh, rules, fsdp = state
    if _model_size(mesh) > 1:
        raise ModelAxisNotPorted(f"reshard_param on mesh {mesh.shape}: the model axis")
    n = mesh.shape.get("data", 1)
    if n <= 1:
        return w
    if len(shape) != w.ndim:
        raise ValueError(f"reshard_param: {tuple(w.shape)} vs full shape {tuple(shape)}")
    spec = _spec_for(tuple(shape), axes, rules, mesh)
    for dim, (entry, full) in enumerate(zip(spec, shape)):
        names = entry if isinstance(entry, tuple) else (entry,)
        sharded = bool(fsdp.intersection(a for a in names if a is not None))
        size = axis_size(mesh, tuple(a for a in names if a in fsdp)) if sharded else 1
        if w.shape[dim] * size != full:
            raise ValueError(
                f"reshard_param: dim {dim} of {tuple(w.shape)} (axes {axes}) is not the "
                f"stored placement {spec} of {tuple(shape)} on {mesh.shape}")
        if size > 1:
            w = _GatherDim.apply(w, dim, mesh.group("data"))
    return w


def _check_model_axis(what: str) -> None:
    state = _state()
    if state is not None and _model_size(state[0]) > 1:
        raise ModelAxisNotPorted(f"{what} on mesh {state[0].shape}: the model axis")


def shard_seq(x: torch.Tensor) -> torch.Tensor:
    """Sequence parallelism of a (B, T, d) layer carry over the model axis:
    the identity while the model axis is one."""
    _check_model_axis("shard_seq")
    return x


def shard_heads(x: torch.Tensor, axis: int = 2) -> torch.Tensor:
    """A (B, T, H, d) tensor's heads on the model axis: the identity while
    the model axis is one."""
    del axis
    _check_model_axis("shard_heads")
    return x
