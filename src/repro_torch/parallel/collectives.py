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
the traffic a step puts on the data axis (``reset_bytes`` zeroes it).
"""
from __future__ import annotations

import torch

# ops gloo runs on CUDA tensors in place; the rest stage through the host
_GLOO_CUDA_OPS = frozenset({"all_reduce", "broadcast"})

BYTES = {"all_gather": 0, "reduce_scatter": 0, "all_reduce": 0}


def reset_bytes() -> None:
    for k in BYTES:
        BYTES[k] = 0


def _count(op: str, x: torch.Tensor) -> None:
    BYTES[op] += x.numel() * x.element_size()


def _dist():
    return torch.distributed


def backend_of(group) -> str:
    return str(_dist().get_backend(group))


def _staged(op: str, x: torch.Tensor, group) -> bool:
    return x.is_cuda and backend_of(group) == "gloo" and op not in _GLOO_CUDA_OPS


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the group (a new tensor; ``x`` is untouched)."""
    out = x.detach().clone().contiguous()
    _count("all_reduce", out)
    _dist().all_reduce(out, group=group)
    return out


def all_gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order."""
    n = _dist().get_world_size(group)
    staged = _staged("all_gather", x, group)
    src = (x.detach().cpu() if staged else x.detach()).movedim(dim, 0).contiguous()
    out = src.new_empty((n * src.shape[0], *src.shape[1:]))
    _count("all_gather", out)
    if backend_of(group) == "nccl":
        _dist().all_gather_into_tensor(out, src, group=group)
    else:
        _dist().all_gather(list(out.chunk(n)), src, group=group)
    out = out.movedim(0, dim)
    return out.to(x.device) if staged else out


def reduce_scatter_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's slice along ``dim`` of the group's sum of ``x`` (the
    dim divides over the group)."""
    n, r = _dist().get_world_size(group), _dist().get_rank(group)
    if x.shape[dim] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} over {n} ranks")
    _count("reduce_scatter", x)
    if backend_of(group) == "nccl":
        src = x.detach().movedim(dim, 0).contiguous()
        out = src.new_empty((src.shape[0] // n, *src.shape[1:]))
        _dist().reduce_scatter_tensor(out, src, group=group)
        return out.movedim(0, dim).contiguous()
    total = x.detach().clone().contiguous()
    _dist().all_reduce(total, group=group)
    return total.narrow(dim, r * (x.shape[dim] // n), x.shape[dim] // n).contiguous()

