"""Request queue with SLO-aware admission for the decode engine (a copy of
``serving/queue.py``; a shed request is a ``request_shed`` event).

A ``Request`` carries its prompt, a generation budget (``max_new``), and an
optional time-to-first-token SLO.  Admission happens once, at ``submit``:
the engine projects the request's TTFT from its measured latency model
(``LatencyModel`` — EMAs of prefill and decode-step cost observed on this
host) and the current backlog; a request whose projection blows its SLO is
**shed immediately** instead of rotting in the queue past its deadline.
Admitted requests are never dropped — page reservation at slot-assignment
time guarantees an admitted request can run to completion.

The projection model is deliberately simple and deterministic (tests drive
it with injected observations):

    wait  = 0                                  if a slot is free for us
          = steps_until_a_slot_frees * step_s  otherwise (k-th smallest
            remaining budget among active slots, k = our queue position)
    TTFT ~= wait + prompt_len * prefill_s_per_token

Cold start (nothing observed yet) projects 0 and admits — the model only
starts shedding once it has real measurements to shed on.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional

from repro_torch.obs.events import emit_event


@dataclasses.dataclass
class Request:
    """One decode request. ``tokens`` is the prompt (token ids)."""

    rid: int
    tokens: list[int]
    max_new: int = 16
    slo_ttft_ms: Optional[float] = None  # None = no deadline, never shed

    @property
    def prompt_len(self) -> int:
        return len(self.tokens)


@dataclasses.dataclass
class Completion:
    """Per-request outcome + latency metrics (seconds, engine clock)."""

    rid: int
    prompt_len: int
    tokens: list[int]  # generated ids, truncated at (and including) EOS
    finish: str  # "eos" | "length" | "shed"
    submit_t: float = 0.0
    first_token_t: Optional[float] = None
    end_t: Optional[float] = None
    token_times: list[float] = dataclasses.field(default_factory=list)

    @property
    def ttft_s(self) -> Optional[float]:
        if self.first_token_t is None:
            return None
        return self.first_token_t - self.submit_t

    @property
    def e2e_s(self) -> Optional[float]:
        if self.end_t is None:
            return None
        return self.end_t - self.submit_t

    @property
    def per_token_s(self) -> list[float]:
        """Inter-token latencies (decode steps; excludes the prefill token)."""
        ts = self.token_times
        return [b - a for a, b in zip(ts, ts[1:])]


class LatencyModel:
    """EMAs of prefill cost (per prompt token) and decode-step cost."""

    def __init__(self, alpha: float = 0.3):
        self.alpha = alpha
        self.prefill_s_per_token: Optional[float] = None
        self.step_s: Optional[float] = None

    def _ema(self, old: Optional[float], new: float) -> float:
        return new if old is None else (1 - self.alpha) * old + self.alpha * new

    def observe_prefill(self, n_tokens: int, seconds: float) -> None:
        self.prefill_s_per_token = self._ema(
            self.prefill_s_per_token, seconds / max(n_tokens, 1)
        )

    def observe_step(self, seconds: float) -> None:
        self.step_s = self._ema(self.step_s, seconds)

    def projected_ttft_s(
        self,
        prompt_len: int,
        queue_position: int,
        free_slots: int,
        active_remaining: list[int],
    ) -> float:
        """Projected TTFT for a request entering at ``queue_position``
        (0 = front) given current occupancy. 0.0 until observations exist."""
        prefill = (self.prefill_s_per_token or 0.0) * prompt_len
        if self.step_s is None:
            return prefill
        ahead = queue_position - free_slots
        if ahead < 0:
            return prefill  # a slot is free for us right now
        if not active_remaining:
            return prefill
        rem = sorted(active_remaining)
        steps = rem[min(ahead, len(rem) - 1)]
        return steps * self.step_s + prefill


class RequestQueue:
    """FIFO of admitted-but-not-yet-scheduled requests + shed decisions."""

    def __init__(self, model: Optional[LatencyModel] = None):
        self.model = model or LatencyModel()
        self._pending: deque[Request] = deque()
        self.shed: list[Request] = []

    def __len__(self) -> int:
        return len(self._pending)

    def offer(
        self, req: Request, free_slots: int, active_remaining: list[int]
    ) -> bool:
        """Admit or shed ``req``; True iff admitted (now queued)."""
        if req.slo_ttft_ms is not None:
            projected = self.model.projected_ttft_s(
                req.prompt_len, len(self._pending), free_slots, active_remaining
            )
            if projected * 1e3 > req.slo_ttft_ms:
                self.shed.append(req)
                emit_event(
                    "request_shed", rid=req.rid, prompt_len=req.prompt_len,
                    slo_ttft_ms=req.slo_ttft_ms,
                    projected_ttft_ms=projected * 1e3,
                    queue_depth=len(self._pending), free_slots=free_slots,
                )
                return False
        self._pending.append(req)
        return True

    def stats(
        self, free_slots: int = 0, active_remaining: Optional[list[int]] = None
    ) -> dict:
        """Snapshot of the admission state: depth, sheds, latency EMAs.

        ``free_slots``/``active_remaining`` (the engine's current occupancy)
        extend the snapshot with the projected TTFT a request arriving at
        the back of the queue would see — the number admission actually
        compares against SLOs.  All values are host floats; callers may
        JSON-serialize the dict as-is.
        """
        out = {
            "queue_depth": len(self._pending),
            "shed_total": len(self.shed),
            "prefill_s_per_token": self.model.prefill_s_per_token,
            "step_s": self.model.step_s,
        }
        if active_remaining is not None:
            out["projected_wait_s"] = self.model.projected_ttft_s(
                0, len(self._pending), free_slots, active_remaining
            )
        return out

    def peek(self) -> Optional[Request]:
        return self._pending[0] if self._pending else None

    def pop(self) -> Request:
        return self._pending.popleft()

    def requeue_front(self, req: Request) -> None:
        self._pending.appendleft(req)
