"""Roofline terms of a dry-run cell (port of ``launch/analysis.py``).

The JAX module reads a compiled XLA program: its cost analysis (bytes
accessed), its post-SPMD HLO text (every collective's output bytes and
replica groups) and its memory analysis.  The port has no compiler: the
dry run (``launch.dryrun``) evaluates one rank's eager step over fake
tensors, and this module turns what that evaluation records into the same
terms:

- ``CollectiveStats`` from the step's collective record
  (``parallel.collectives.recording``): per collective its kind, its output
  bytes and its group's size, with the JAX parser's ring factors (a
  collective over a one-rank group, which XLA never emits and the port
  runs as a copy, is counted and moves nothing over the link);
- ``MemoryTracker``, the counterpart of ``memory_analysis()``: the live
  bytes of every storage the step allocates, at their peak, and the bytes
  its ops read and write;
- ``RooflineTerms`` / ``roofline_terms``, field for field the JAX ones.

Hardware model: one NVIDIA H100 SXM 80GB (NVIDIA's data sheet and the
Hopper architecture white paper, as tabled in the repository's
hopper-kernels guide).  Every time this module writes is a prediction from
those published constants, not a measurement.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Iterable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

PEAK_FLOPS = 989e12  # bf16 dense, tensor cores, per card (H100 SXM data sheet)
HBM_BW = 3.35e12  # bytes/s per card, HBM3 (H100 SXM data sheet)
NVLINK_BW = 450e9  # bytes/s each way per card: NVLink 4's 900 GB/s (Hopper white paper)

# the port's collectives (parallel.collectives.BYTES keys) by their HLO names
KINDS = {"all_reduce": "all-reduce", "all_gather": "all-gather",
         "reduce_scatter": "reduce-scatter"}


def _ring_factor(kind: str, n: int) -> float:
    """Wire bytes per output byte of one collective over ``n`` ranks (the
    JAX parser's ring model)."""
    if n <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * (n - 1) / n
    if kind in ("all-gather", "reduce-scatter", "all-to-all"):
        return (n - 1) / n
    return 1.0  # collective-permute


@dataclasses.dataclass
class CollectiveStats:
    counts: dict[str, int]
    raw_bytes: dict[str, float]  # per-device output bytes by op kind
    wire_bytes: float  # ring-model effective bytes over the NVLink

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_records(cls, records: Iterable[tuple[str, int, int]]) -> CollectiveStats:
        """From ``(kind, bytes, group size)`` records: a port op with its
        bytes as ``collectives.BYTES`` counts them (a reduce-scatter's input,
        whose output is 1/n of it), or an HLO kind with its output bytes."""
        counts: dict[str, int] = {}
        raw: dict[str, float] = {}
        wire = 0.0
        for op, nbytes, n in records:
            kind = KINDS.get(op, op)
            out = nbytes // n if op == "reduce_scatter" else nbytes
            counts[kind] = counts.get(kind, 0) + 1
            raw[kind] = raw.get(kind, 0.0) + out
            wire += _ring_factor(kind, n) * out
        return cls(counts=counts, raw_bytes=raw, wire_bytes=wire)


def _storage(t: torch.Tensor):
    return t.untyped_storage()


def tree_storage_bytes(tree: Any) -> dict[int, int]:
    """{id: bytes} of the distinct storages under a tree's tensors."""
    out = {}
    for x in tree_leaves(tree):
        if isinstance(x, torch.Tensor):
            st = _storage(x)
            out[id(st)] = st.nbytes()
    return out


def _tensors(xs) -> list:
    """The tensors among ``xs`` and in its lists and tuples (an op's
    arguments and results nest no deeper)."""
    out = []
    for x in xs:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            out.extend(y for y in x if isinstance(y, torch.Tensor))
    return out


_NO_ACCESS = frozenset({"empty", "empty_like", "empty_strided", "new_empty",
                        "new_empty_strided"})


class MemoryTracker(TorchDispatchMode):
    """The storages the ops inside allocate, alive and at their peak, and
    the bytes the ops read and write (real or fake tensors alike).

    A storage counts from the op that first returns it until it dies; an
    output that shares a storage with one of its op's inputs (a view, an
    in-place or ``out=`` op, a collective's buffer) allocates nothing.
    Storages made before count where ``add`` registers them (the step's
    arguments).  ``bytes_accessed`` sums, over every op but views,
    allocations that write nothing (``empty``) and metadata queries, the
    bytes of its tensor operands and outputs: unfused, op by op, so not
    comparable with XLA's count of a fused program.  Enter it inside a
    ``FakeTensorMode``, so that it sees each op before the fake mode does.
    """

    def __init__(self):
        super().__init__()
        self.live: dict[int, int] = {}
        self.current = 0
        self.peak = 0
        self.largest = 0  # the largest single storage
        self.bytes_accessed = 0
        self.ops = 0

    def _gone(self, key: int) -> None:
        self.current -= self.live.pop(key, 0)

    def _track(self, st) -> None:
        key = id(st)
        if key in self.live:
            return
        n = st.nbytes()
        self.live[key] = n
        self.current += n
        self.peak = max(self.peak, self.current)
        self.largest = max(self.largest, n)
        weakref.finalize(st, self._gone, key)

    def add(self, tree: Any) -> int:
        """Register a tree's storages as live (the arguments); their bytes."""
        seen = 0
        for x in tree_leaves(tree):
            if isinstance(x, torch.Tensor) and id(_storage(x)) not in self.live:
                self._track(_storage(x))
                seen += self.live[id(_storage(x))]
        return seen

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.namespace == "prim":  # metadata queries
            return out
        self.ops += 1
        ins = _tensors(args) + (_tensors(kwargs.values()) if kwargs else [])
        outs = _tensors(out if isinstance(out, (list, tuple)) else (out,))
        if not func.is_view and func._opname not in _NO_ACCESS:
            self.bytes_accessed += sum(x.numel() * x.element_size() for x in ins + outs)
        if not func.is_view:
            aliased = {id(_storage(x)) for x in ins}
            for x in outs:
                st = _storage(x)
                if id(st) not in aliased:
                    self._track(st)
        return out


@dataclasses.dataclass
class RooflineTerms:
    flops_per_device: float
    bytes_per_device: float
    wire_bytes_per_device: float
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: float  # 6*N*D useful flops (global)
    useful_flops_ratio: float  # model_flops / (analytic flops * n_devices)
    memory_stats: dict
    collectives: dict

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def roofline_terms(
    memory_stats: dict,
    *,
    n_devices: int,
    flops_global: float,
    bytes_per_device: float,
    wire_bytes_per_device: float,
    model_flops: float = 0.0,
) -> RooflineTerms:
    """The JAX terms on the H100's constants; ``memory_stats`` has the keys
    of the JAX one (argument, output, temp and alias bytes and the peak
    estimate), from the dry run's tracker."""
    flops = flops_global / n_devices
    compute_s = flops / PEAK_FLOPS
    memory_s = bytes_per_device / HBM_BW
    collective_s = wire_bytes_per_device / NVLINK_BW
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    total = flops * n_devices
    return RooflineTerms(
        flops_per_device=flops,
        bytes_per_device=bytes_per_device,
        wire_bytes_per_device=wire_bytes_per_device,
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        bottleneck=max(terms, key=terms.get),
        model_flops=model_flops,
        useful_flops_ratio=(model_flops / total) if total else 0.0,
        memory_stats=dict(memory_stats),
        collectives={},
    )
