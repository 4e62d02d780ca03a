"""Max physical microbatch search (the paper's Table 7, reused as a runtime
feature; port of ``tuner/max_batch.py``).

The paper bisects the largest batch that trains without running out of
memory on a 16 GB V100 (``DEFAULT_BUDGET_BYTES``).  Here every candidate
batch is certified by a **trial**: ``max_batch_by_trial`` runs the clipped
gradient step at that batch and waits for it, so the certificate covers
what no model sees (allocator fragmentation, cuDNN and cuBLAS workspaces).
On the card the budget is enforced, not assumed: the caching allocator is
capped with ``torch.cuda.set_per_process_memory_fraction((budget -
reserved) / total)`` for the search and the fraction is restored afterwards,
on error too.  A trial that fails to allocate (``torch.OutOfMemoryError``,
host ``MemoryError`` or cuBLAS's ``CUBLAS_STATUS_ALLOC_FAILED``) is
caught, the allocator recovered (``gc`` + ``torch.cuda.empty_cache``) and
the search goes on below it; any other error propagates, since a kernel
that fails at a large batch is a bug, not "does not fit".  Within about a
percent of the answer the outcome of a trial is not a function of the
batch alone (the allocator's rounding and fragmentation: on the H100 a
BEiT-Large step at 364 samples failed twice where 365 ran), so each
attempt starts from a recovered allocator with the cyclic collector
paused (``trial_survives``), and the search certifies the largest batch
its bisection met only once a repeat trial of it holds (else it steps down
a percent at a time).

Torch has no counterpart of the reference's ``compiled_memory_bytes`` (XLA's
compile-time memory analysis).  Its place is taken by a measured model
(``extrapolate``): the line through the ``max_memory_allocated`` of the
two largest trials that ran so far, which the doubling search provides
for free.  It only pre-filters trials on the card: a candidate it puts
above ``MODEL_SLACK`` times the budget is not run (the doubling's
overshoot, the far half of the bisection), so near the answer every
candidate is tried; the two largest trials sit where the answer is, and
the fit costs no trial of its own.  On the CPU there is no device
peak to read, so a CPU search runs its trials alone and cannot observe a
budget (every execution fits the host).  ``certify_max_batch`` certifies by trial wherever the tensors
are concrete, as the reference does; the reference's ``"memory"`` method
(its compile-time model alone) has no counterpart.

The result feeds gradient accumulation: a fixed logical batch (the privacy
unit) runs as ``accumulation_steps`` microbatches of the certified size.
"""
from __future__ import annotations

import gc
import logging
import os
from typing import Any, Callable, Optional

import torch

from repro_torch.utils.tree import flatten_dict, tree_map

log = logging.getLogger("repro_torch.tuner.max_batch")

DEFAULT_BUDGET_BYTES = 16 * 1024**3  # the paper's 16 GB V100
# the measured model pre-filters only candidates it puts this far above the
# budget: a linear fit from two small batches must not rule out a batch
# that fits
MODEL_SLACK = 1.25
# steps of a percent the search may take down from its answer until a
# repeat trial holds (each a fresh trial of the certificate)
CONFIRM_STEPS = 5

# allocation failures that do not raise torch.OutOfMemoryError
_ALLOC_TOKENS = ("CUBLAS_STATUS_ALLOC_FAILED",)


def is_oom_error(e: BaseException) -> bool:
    """True when the exception is an allocation failure, and only then."""
    if isinstance(e, (torch.OutOfMemoryError, MemoryError)):
        return True
    return any(tok in str(e) for tok in _ALLOC_TOKENS)


def find_max_physical_batch(
    fits: Callable[[int], bool], *, lo: int = 1, hi_cap: int = 65536
) -> int:
    """Largest b in [lo, hi_cap] with fits(b), by doubling + exact bisection.

    Assumes ``fits`` is monotone (true below some threshold).  Returns 0 when
    even ``lo`` does not fit.
    """
    if not fits(lo):
        return 0
    hi = lo
    while hi < hi_cap and fits(min(hi * 2, hi_cap)):
        hi = min(hi * 2, hi_cap)
    if hi >= hi_cap:
        return hi_cap
    # fits(hi) held and fits(min(2 hi, hi_cap)) just failed: the bisection's
    # upper bound (each fits() is a trial; never re-test a failing point)
    bad = min(hi * 2, hi_cap)
    while bad - hi > 1:
        mid = (hi + bad) // 2
        if fits(mid):
            hi = mid
        else:
            bad = mid
    return hi


def resident_state_bytes(params: Any) -> int:
    """Training-loop memory one clipped-gradient call does not hold: the
    optimizer state (Adam: 2 fp32 copies of the parameters) and, under
    accumulation, the fp32 gradient sum and its transient twin, reserved off
    the budget so the certified batch fits the loop."""
    n = sum(int(x.numel()) for x in flatten_dict(params).values())
    return 4 * 4 * n


def batch_at(batch: Any, b: int) -> Any:
    """``batch`` resized to leading dim ``b`` (rows recycled: the content does
    not change the memory)."""

    def resize(x: torch.Tensor) -> torch.Tensor:
        n = x.shape[0]
        if b <= n:
            return x[:b]
        return x.repeat((-(-b // n),) + (1,) * (x.dim() - 1))[:b]

    return tree_map(resize, batch)


def _device_of(params: Any, batch: Any) -> torch.device:
    leaves = list(flatten_dict(params).values()) + list(flatten_dict(batch).values())
    return leaves[0].device


def recover_allocator() -> None:
    """The retry ladder's recovery: drop the failed trial's tensors and
    return the allocator's cached blocks to the device."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    gc.collect()


def trial_survives(run: Callable[[int], Any], b: int, *, attempts: int = 2) -> bool:
    """Execute ``run(b)`` under the allocation-failure retry ladder; True
    when it completes.

    Every attempt starts from a recovered allocator (the last trial's
    cached blocks returned) and runs with Python's cyclic collector paused:
    at the edge of the budget a trial's fate otherwise turns on what an
    earlier trial left cached and on when a collection frees cyclic
    garbage.  A failure gets one retry (fragmentation and a batch that is
    too large look alike); a repeat reports "does not fit".  Any error that
    is not an allocation failure propagates.
    """
    attempts = max(attempts, 1)
    for attempt in range(1, attempts + 1):
        recover_allocator()
        collecting = gc.isenabled()
        gc.disable()
        try:
            run(b)
            return True
        except Exception as e:  # noqa: BLE001 - filtered to allocation failures
            if not is_oom_error(e):
                raise
        finally:
            if collecting:
                gc.enable()
        # out of the handler: the traceback no longer holds the trial's tensors
        if attempt == attempts:
            recover_allocator()
            log.debug("batch %d does not fit (attempt %d/%d)", b, attempt, attempts)
            return False
        log.info("batch %d failed to allocate; retrying from a recovered allocator "
                 "(attempt %d/%d)", b, attempt, attempts)
    return False


def _default_runner(grad_fn: Callable, params: Any, batch: Any) -> Callable[[int], None]:
    def runner(b: int) -> None:
        out = grad_fn(params, batch_at(batch, b))
        dev = out[0].device
        del out
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    return runner


def extrapolate(peaks: dict[int, int], b: int) -> Optional[float]:
    """The measured memory model: bytes at batch ``b`` on the line through
    the peaks of the two largest batches in ``peaks`` ({batch: peak bytes}
    of trials that ran); None with fewer than two."""
    if len(peaks) < 2:
        return None
    (b1, m1), (b2, m2) = sorted(peaks.items())[-2:]
    return m2 + max(m2 - m1, 0) / (b2 - b1) * (b - b2)


class _memory_fraction:
    """Cap the caching allocator at ``budget`` bytes of ``device`` for the
    block; the previous fraction comes back on exit, on error too."""

    def __init__(self, device: torch.device, budget: int):
        self.device, self.budget = device, budget

    def __enter__(self):
        total = torch.cuda.get_device_properties(self.device).total_memory
        get = getattr(torch.cuda, "get_per_process_memory_fraction", None)
        self.saved = 1.0 if get is None else get(self.device)
        recover_allocator()
        torch.cuda.set_per_process_memory_fraction(min(self.budget / total, 1.0), self.device)
        return self

    def __exit__(self, *exc):
        torch.cuda.set_per_process_memory_fraction(self.saved, self.device)
        recover_allocator()
        return False


def max_batch_by_trial(
    grad_fn: Callable,
    params: Any,
    batch: Any,
    *,
    budget_bytes: Optional[int] = DEFAULT_BUDGET_BYTES,
    hi_cap: int = 65536,
    reserved_bytes: int = 0,
    runner: Optional[Callable[[int], Any]] = None,
    attempts: int = 2,
) -> int:
    """Largest physical batch whose clipping step executes within budget.

    Each candidate runs ``grad_fn`` (``runner`` injects the execution for
    tests: it gets the batch size and must raise on a failed allocation).
    On the card, with ``budget_bytes`` set, the allocator is capped at
    ``budget_bytes - reserved_bytes`` for the search, and the measured model
    pre-filters.  On the CPU the trials run alone and the
    budget is not observed.  ``budget_bytes=None`` trusts execution alone.
    """
    dev = _device_of(params, batch)
    cap = None
    if budget_bytes is not None:
        cap = budget_bytes - reserved_bytes
        if cap <= 0:
            log.warning("memory budget entirely consumed by resident state "
                        "(%.2f GB reserved)", reserved_bytes / 1024**3)
            return 0
    if runner is None:
        runner = _default_runner(grad_fn, params, batch)
    on_card = cap is not None and dev.type == "cuda"
    peaks: dict[int, int] = {}  # batch -> peak bytes of a trial that ran

    def fits(b: int) -> bool:
        if on_card:
            m = extrapolate(peaks, b)
            if m is not None and m > MODEL_SLACK * cap:
                log.debug("batch %d rejected by the memory model (%.2f GB)", b, m / 1024**3)
                return False
            torch.cuda.reset_peak_memory_stats(dev)
        if not trial_survives(runner, b, attempts=attempts):
            return False
        if on_card:
            peaks[b] = torch.cuda.max_memory_allocated(dev)
        return True

    def search() -> int:
        b = find_max_physical_batch(fits, hi_cap=hi_cap)
        # the certificate is a batch that runs once more from a recovered
        # allocator: near the edge one success is not a property of the
        # batch alone, so step down a percent at a time until one holds
        for _ in range(CONFIRM_STEPS):
            if b <= 0 or trial_survives(runner, b, attempts=attempts):
                return b
            log.info("batch %d did not run again; stepping down", b)
            b -= max(1, b // 100)
        return 0

    if not on_card:
        return search()
    with _memory_fraction(dev, cap):
        return search()


def trials_available(params: Any, batch: Any) -> bool:
    """Trials need concrete tensors (none on the ``meta`` device)."""
    leaves = list(flatten_dict(params).values()) + list(flatten_dict(batch).values())
    return all(isinstance(x, torch.Tensor) and x.device.type != "meta" for x in leaves)


def certify_max_batch(
    grad_fn: Callable,
    params: Any,
    batch: Any,
    *,
    budget_bytes: int = DEFAULT_BUDGET_BYTES,
    hi_cap: int = 65536,
    reserved_bytes: int = 0,
    method: Optional[str] = None,
) -> tuple[int, str]:
    """(max physical batch, certification method): the search front door.

    ``method`` (or ``REPRO_MAX_BATCH_METHOD``): ``"auto"`` (the default) or
    ``"trial"``; both certify by trial, which needs concrete tensors.  The
    reference's ``"memory"`` method (XLA's compile-time model, usable on
    shapes alone) has no torch counterpart and raises, as do inputs without
    concrete tensors.
    """
    method = method or os.environ.get("REPRO_MAX_BATCH_METHOD", "auto")
    if method not in ("auto", "trial"):
        raise ValueError(f"max-batch method {method!r}: the port certifies by trial only "
                         "('auto' or 'trial'; the memory model only pre-filters trials)")
    if not trials_available(params, batch):
        raise ValueError(
            "the max-batch search needs concrete tensors: trials run the step, and "
            "the measured memory model reads the peaks of two trials")
    return max_batch_by_trial(grad_fn, params, batch, budget_bytes=budget_bytes,
                              hi_cap=hi_cap, reserved_bytes=reserved_bytes), "trial"


def derive_accumulation(logical_batch: int, max_physical: int) -> tuple[int, int]:
    """(physical_batch, accumulation_steps) realizing a fixed logical batch.

    The fewest microsteps within the memory bound, then an even microbatch
    (logical 256 with max 96 -> 86 x 3, not 96 + 96 + 64).  Guarantees
    physical <= max_physical and physical * steps >= logical.
    """
    if logical_batch <= 0:
        raise ValueError(f"logical_batch must be positive, got {logical_batch}")
    if max_physical <= 0:
        raise ValueError(f"max_physical must be positive, got {max_physical}")
    steps = -(-logical_batch // max_physical)
    physical = -(-logical_batch // steps)
    return physical, steps
