"""Launch counters of the port's kernels, one plain integer per (kernel, impl).

A CUDA wrapper adds one to its ``cuda`` count where it launches its kernel;
the dispatch layer adds one to the ``torch`` count where it runs the plain
version instead; an abstract evaluation (a dry run over fake tensors) adds
one to the ``fake`` count where the kernel would launch.  ``chip_smoke.py``
and the tests zero the counts before driving a training step or the
serving engine and read them after, to show which path ran.
"""
from __future__ import annotations

KERNELS = (
    "ghost_norm_sq", "embedding_ghost_norm_sq", "book_weighted_grad", "psg_contract",
    "flash_attention",
)
IMPLS = ("cuda", "torch", "fake")

COUNTS: dict[str, dict[str, int]] = {k: {i: 0 for i in IMPLS} for k in KERNELS}


def record(kernel: str, impl: str) -> None:
    COUNTS[kernel][impl] += 1


def reset() -> None:
    for per_impl in COUNTS.values():
        for impl in per_impl:
            per_impl[impl] = 0


def snapshot() -> dict[str, dict[str, int]]:
    return {k: dict(v) for k, v in COUNTS.items()}
