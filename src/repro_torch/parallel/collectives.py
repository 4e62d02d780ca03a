"""Collectives over one mesh axis, on any backend.

NCCL runs every op on CUDA tensors.  Gloo runs all_reduce and broadcast
on CUDA tensors but not all_gather or reduce_scatter, and no reduce_scatter
at all on some builds; so on gloo the port stages a CUDA tensor of those
ops through a host buffer, and runs reduce_scatter as an all_reduce of the
whole tensor followed by this rank's slice.  The choice is made by the
group's backend, before the call (never by catching an error).  Every op
is synchronous and issued in program order, so ranks that run the same
program issue the same collectives in the same order.

``BYTES`` counts, per op, the bytes of this rank's full-size buffer (an
all_gather's output, a reduce_scatter's input, an all_reduce's tensor):
the traffic a step puts on the mesh's axes (``reset_bytes`` zeroes it).
Inside ``recording()`` each collective is also kept, in issue order, as
``(op, bytes as BYTES counts them, group)``: the ring model of
``launch.analysis`` needs each group's size, which ``records()`` reads.
The record is off by default (a training run that never resets the counts
would grow it step after step); on, it costs the live path one append a
collective, and ``reset_bytes`` clears it too.

Serving on the model axis (no autograd) uses ``all_reduce`` with ``op="max"``,
``all_gather_dim`` over heads (a decode's query heads, a cache's KV heads)
and ``merge_softmax``, the context-parallel decode's merge of each rank's
partial softmax ``(o, m, l)``.

The autograd functions of tensor and sequence parallelism (Megatron's
conjugate pairs) are here too, each over the group it is given:

- ``copy_to_model``      identity forward, all-reduce backward: the input
                         of a column-parallel product (each rank's part of
                         the input's gradient is summed);
- ``reduce_from_model``  all-reduce forward, identity backward: the output
                         of a row-parallel product (its partial sums);
- ``sum_parts``          all-reduce forward and backward: a sum of the
                         ranks' parts that each rank then uses for its own
                         slice (a norm's sum of squares over split
                         channels), so its gradient parts sum too;
- ``split_along``        this rank's slice forward, all-gather backward: a
                         replicated activation stored sharded (the sequence
                         of a layer carry);
- ``gather_along``       all-gather forward, this rank's slice backward:
                         a sharded activation used whole by a computation
                         every rank repeats (its gradient is the same on
                         every rank);
- ``gather_along_sum``   all-gather forward, reduce-scatter backward: a
                         sharded tensor used whole by computations that
                         differ per rank (an FSDP weight, a KV projection
                         split inside a head), whose gradient parts sum.

Their backwards run where autograd runs them (for a CUDA tensor, its
device thread; also in a checkpointed layer's recomputation and in a
second backward over a retained graph).  Ranks that build the same graph
run them in the same order.
"""
from __future__ import annotations

import contextlib
from typing import Iterator

import torch

# ops gloo runs on CUDA tensors in place; the rest stage through the host
_GLOO_CUDA_OPS = frozenset({"all_reduce", "broadcast"})

BYTES = {"all_gather": 0, "reduce_scatter": 0, "all_reduce": 0}
_RECORD: list = []  # the open recording()'s list, if any


def reset_bytes() -> None:
    for k in BYTES:
        BYTES[k] = 0
    if _RECORD:
        _RECORD[-1].clear()


@contextlib.contextmanager
def recording() -> Iterator[list]:
    """Keep every collective issued inside as ``(op, bytes, group)``."""
    _RECORD.append([])
    try:
        yield _RECORD[-1]
    finally:
        _RECORD.pop()


def records(record: list) -> list[tuple[str, int, int]]:
    """A ``recording()`` list as ``(op, bytes, group size)`` (read while the
    groups live)."""
    return [(op, n, _dist().get_world_size(group)) for op, n, group in record]


def _count(op: str, x: torch.Tensor, group) -> None:
    n = x.numel() * x.element_size()
    BYTES[op] += n
    if _RECORD:
        _RECORD[-1].append((op, n, group))


def _dist():
    return torch.distributed


def backend_of(group) -> str:
    return str(_dist().get_backend(group))


def _staged(op: str, x: torch.Tensor, group) -> bool:
    return x.is_cuda and backend_of(group) == "gloo" and op not in _GLOO_CUDA_OPS


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """The sum (or ``op="max"``: the maximum) of ``x`` over the group (a new
    tensor; ``x`` is untouched)."""
    out = x.detach().clone().contiguous()
    _count("all_reduce", out, group)
    ops = _dist().ReduceOp
    _dist().all_reduce(out, op=ops.MAX if op == "max" else ops.SUM, group=group)
    return out


@torch.no_grad()
def merge_softmax(o: torch.Tensor, m: torch.Tensor, l: torch.Tensor, group) -> torch.Tensor:
    """The attention output of every rank's rows from each rank's partial
    softmax: ``o`` (..., hd) the unnormalised sum of exp(s - m) v over this
    rank's rows, ``m`` (...) their largest score, ``l`` (...) the sum of
    exp(s - m).  One all-reduce ``max`` of m, then one all-reduce of l and o
    rescaled to it (packed in one tensor); a rank that holds no live row
    (m at the masked score, l = 0, o = 0) adds nothing."""
    top = all_reduce(m, group, op="max")
    w = torch.exp(m - top)
    packed = all_reduce(torch.cat([w[..., None] * o, (w * l)[..., None]], dim=-1), group)
    return packed[..., :-1] / packed[..., -1:].clamp_min(1e-30)


def all_gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order."""
    n = _dist().get_world_size(group)
    staged = _staged("all_gather", x, group)
    src = (x.detach().cpu() if staged else x.detach()).movedim(dim, 0).contiguous()
    out = src.new_empty((n * src.shape[0], *src.shape[1:]))
    _count("all_gather", out, group)
    if backend_of(group) == "nccl":
        _dist().all_gather_into_tensor(out, src, group=group)
    else:
        _dist().all_gather(list(out.chunk(n)), src, group=group)
    # contiguous in ``x``'s dim order, as one rank holds the tensor: a view
    # with the gathered dim outermost would make later reductions (a
    # GroupNorm's statistics) sum in another order
    out = out.movedim(0, dim).contiguous()
    return out.to(x.device) if staged else out


def reduce_scatter_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's slice along ``dim`` of the group's sum of ``x`` (the
    dim divides over the group)."""
    n, r = _dist().get_world_size(group), _dist().get_rank(group)
    if x.shape[dim] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} over {n} ranks")
    _count("reduce_scatter", x, group)
    if backend_of(group) == "nccl":
        src = x.detach().movedim(dim, 0).contiguous()
        out = src.new_empty((src.shape[0] // n, *src.shape[1:]))
        _dist().reduce_scatter_tensor(out, src, group=group)
        return out.movedim(0, dim).contiguous()
    total = x.detach().clone().contiguous()
    _dist().all_reduce(total, group=group)
    return total.narrow(dim, r * (x.shape[dim] // n), x.shape[dim] // n).contiguous()


def _slice(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's contiguous 1/n of ``x`` along ``dim``."""
    n, r = _dist().get_world_size(group), _dist().get_rank(group)
    if x.shape[dim] % n:
        raise ValueError(f"slice: dim {dim} of {tuple(x.shape)} over {n} ranks")
    size = x.shape[dim] // n
    return x.narrow(dim, r * size, size).contiguous()


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumParts(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _slice(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return all_gather_dim(g, ctx.dim, ctx.group), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.dim, ctx.group), None, None


class _GatherSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_dim(g, ctx.dim, ctx.group), None, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyTo.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFrom.apply(x, group)


def sum_parts(x: torch.Tensor, group) -> torch.Tensor:
    return _SumParts.apply(x, group)


def split_along(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return _Split.apply(x, dim % x.ndim, group)


def gather_along(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return _Gather.apply(x, dim % x.ndim, group)


def gather_along_sum(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return _GatherSum.apply(x, dim % x.ndim, group)
