"""repro_torch.serving: continuous-batching decode service (port of
``repro.serving``).

- ``engine``     ``Engine``: submit/step/drain orchestrator, batched decode
  over the lanes + per-slot prefill install.
- ``scheduler``  ``SlotScheduler``: lane occupancy, per-slot page tables,
  next-step slot recycling.
- ``queue``      ``RequestQueue`` + ``LatencyModel``: SLO-aware admission.
- ``kv_pages``   paged KV pool: fixed-size pages, shared page table.
- ``reference``  ``sequential_decode``: the exactness oracle.
"""
from repro_torch.serving.engine import Engine, aggregate_metrics
from repro_torch.serving.kv_pages import PageAllocator
from repro_torch.serving.queue import Completion, LatencyModel, Request, RequestQueue
from repro_torch.serving.reference import sequential_decode
from repro_torch.serving.scheduler import SlotScheduler

__all__ = [
    "Engine",
    "aggregate_metrics",
    "PageAllocator",
    "Completion",
    "LatencyModel",
    "Request",
    "RequestQueue",
    "sequential_decode",
    "SlotScheduler",
]
