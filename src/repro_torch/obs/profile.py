"""Profiler trace capture around a step window (port of ``obs/profile.py``).

``torch.profiler.profile`` brackets the inclusive step range ``[N, M]``
(``--profile-steps N:M``): the trace opens before step N is enqueued and
closes after step M's sync point, so the captured window holds exactly
M-N+1 logical batches.  CPU activity is always traced, CUDA activity on the
card.  The train loop marks each step in the window with ``span(step)``, a
``record_function`` named ``train_step#<step>``: the trace then holds one
host span per step and, on the card, one device span (``gpu_user_annotation``)
over the kernels the step launched, which ``repro_torch.obs.timeline`` reads.
The trace is written as Chrome-trace JSON under ``<run_dir>/profile/``.

Where the JAX window logs and carries on untraced when the profiler fails,
this one raises on the card: a run asked to profile the GPU either writes a
trace or fails.  On the CPU a profiler that cannot start or export logs a
warning and the run goes on untraced, as in the JAX package.
"""
from __future__ import annotations

import contextlib
import os
import pathlib
import socket
from typing import Optional

from repro_torch.obs.events import emit_event
from repro_torch.utils.logging import get_logger

log = get_logger("obs.profile")

STEP_SPAN = "train_step#{}"


def parse_window(spec: str) -> tuple[int, int]:
    """``"N:M"`` -> inclusive (first, last) step; ``"N"`` means one step."""
    lo_s, _, hi_s = spec.partition(":")
    try:
        lo = int(lo_s)
        hi = int(hi_s) if hi_s else lo
    except ValueError as e:
        raise ValueError(
            f"bad --profile-steps spec {spec!r}: expected N or N:M"
        ) from e
    if lo < 0 or hi < lo:
        raise ValueError(
            f"bad --profile-steps window {spec!r}: need 0 <= N <= M"
        )
    return lo, hi


class ProfileWindow:
    """Drives one ``torch.profiler`` session from the train loop.

    The loop calls ``before_step(step)`` ahead of enqueueing a step, runs the
    step inside ``span(step)`` and calls ``after_step(step)`` once the step's
    sync point has passed; ``stop()`` (idempotent) runs in the loop's
    ``finally`` so a crash inside the window still writes a partial trace.
    ``device`` is where the steps run: on a CUDA device the profiler traces
    its kernels and any failure to start or export raises.
    """

    def __init__(self, first: int, last: int, trace_dir, device="cpu"):
        import torch

        self.first = first
        self.last = last
        self.trace_dir = pathlib.Path(trace_dir)
        self.device = torch.device(device)
        self.active = False
        self.done = False
        self.trace_path: Optional[pathlib.Path] = None
        self._prof = None

    @classmethod
    def from_spec(cls, spec: str, run_dir, device="cpu") -> "ProfileWindow":
        first, last = parse_window(spec)
        return cls(first, last, pathlib.Path(run_dir) / "profile", device)

    def _failed(self, what: str, e: Exception) -> None:
        self.done = True
        if self.device.type == "cuda":
            raise RuntimeError(f"profiler could not {what} on {self.device}: "
                               f"{type(e).__name__}: {e}") from e
        log.warning("profiler could not %s (%s: %s); continuing untraced",
                    what, type(e).__name__, e)

    def before_step(self, step: int) -> None:
        if self.done or self.active or not (self.first <= step <= self.last):
            return
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        try:
            self.trace_dir.mkdir(parents=True, exist_ok=True)
            self._prof = profile(activities=activities)
            self._prof.start()
        except Exception as e:  # noqa: BLE001 - backend-dependent; raised on the card
            self._prof = None
            self._failed("start", e)
            return
        self.active = True
        log.info("profiler trace open: steps [%d, %d] -> %s",
                 self.first, self.last, self.trace_dir)
        emit_event("profile_started", step=step, first=self.first,
                   last=self.last, trace_dir=str(self.trace_dir))

    def span(self, step: int):
        """The step's ``record_function`` while the trace is open, else a
        no-op context."""
        if not self.active:
            return contextlib.nullcontext()
        from torch.profiler import record_function

        return record_function(STEP_SPAN.format(step))

    def after_step(self, step: int) -> None:
        if self.active and step >= self.last:
            self.stop(step=step)

    def stop(self, step: Optional[int] = None) -> None:
        if not self.active:
            return
        self.active = False
        self.done = True
        path = self.trace_dir / f"{socket.gethostname()}.{os.getpid()}.trace.json"
        try:
            self._prof.stop()
            self._prof.export_chrome_trace(str(path))
        except Exception as e:  # noqa: BLE001 - backend-dependent; raised on the card
            self._failed("export its trace", e)
            return
        finally:
            self._prof = None
        self.trace_path = path
        log.info("profiler trace written: %s", path)
        emit_event("profile_stopped", step=step, trace_dir=str(self.trace_dir))
