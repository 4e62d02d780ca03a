"""Slot scheduler: continuous-batching occupancy bookkeeping (a copy of
``serving/scheduler.py``).

The decode batch is a fixed set of ``n_slots`` lanes; the scheduler owns
which request occupies which lane, each lane's page-table row, and the
per-lane progress counters.  The continuous-batching contract: the step a
request finishes, its slot and pages are freed and the *next* queued
request can prefill into that slot before the following decode step — no
wave barriers, the other lanes never stop decoding.

All state here is host-side (numpy page table, python counters); the
device-side state this mirrors lives in the engine's dense/pool pytrees.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.serving.kv_pages import NULL_PAGE, PageAllocator
from repro_torch.serving.queue import Completion, Request


@dataclasses.dataclass
class Slot:
    """One decode lane's occupancy state."""

    index: int
    request: Optional[Request] = None
    completion: Optional[Completion] = None
    pages: list[int] = dataclasses.field(default_factory=list)
    # cache rows written so far (prompt + decode inputs); mirrors the
    # device-side per-lane cache idx
    length: int = 0
    generated: int = 0
    last_token: int = 0

    @property
    def active(self) -> bool:
        return self.request is not None

    @property
    def remaining(self) -> int:
        return 0 if self.request is None else self.request.max_new - self.generated


class SlotScheduler:
    """Assigns queued requests to freed slots and reserves their pages."""

    def __init__(self, n_slots: int, allocator: PageAllocator, max_pages: int):
        self.slots = [Slot(i) for i in range(n_slots)]
        self.allocator = allocator
        self.max_pages = max_pages
        # shared across every layer's KV leaves; row i belongs to slot i
        self.table = np.full((n_slots, max_pages), NULL_PAGE, np.int32)

    @property
    def n_slots(self) -> int:
        return len(self.slots)

    def free_slots(self) -> list[Slot]:
        return [s for s in self.slots if not s.active]

    def active_slots(self) -> list[Slot]:
        return [s for s in self.slots if s.active]

    def active_remaining(self) -> list[int]:
        return [s.remaining for s in self.active_slots()]

    def assign(self, req: Request, completion: Completion) -> Optional[Slot]:
        """Bind ``req`` to a free slot, reserving its worst-case pages.

        Returns the slot, or None when no slot is free or the pool cannot
        cover the request right now (it stays queued — admission already
        accepted it, so it waits rather than sheds).
        """
        free = self.free_slots()
        if not free:
            return None
        # worst-case cache rows: the prompt plus every decode input (the
        # final generated token is never written back)
        pages = self.allocator.reserve(req.prompt_len + max(req.max_new - 1, 0))
        if pages is None:
            return None
        slot = free[0]
        slot.request = req
        slot.completion = completion
        slot.pages = pages
        slot.length = req.prompt_len
        slot.generated = 0
        row = np.full((self.max_pages,), NULL_PAGE, np.int32)
        row[: len(pages)] = pages
        self.table[slot.index] = row
        return slot

    def release(self, slot: Slot) -> None:
        """Recycle a finished slot: pages back to the pool, row nulled so
        the lane's idle decode writes land in the sacrificial page."""
        self.allocator.release(slot.pages)
        self.table[slot.index] = NULL_PAGE
        slot.request = None
        slot.completion = None
        slot.pages = []
        slot.length = 0
        slot.generated = 0
        slot.last_token = 0
