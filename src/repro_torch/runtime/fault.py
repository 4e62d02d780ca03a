"""Fault tolerance (a copy of ``runtime/fault.py``): straggler watchdog,
preemption handling, retry.

At fleet scale the failure modes are (a) slow steps — a straggling host makes
every collective wait; (b) preemption — the scheduler reclaims nodes with a
grace window; (c) transient infra errors.  The mitigations here are the
host-side halves: detect + checkpoint + clean restart (the launcher's
``--auto-restart`` loop re-runs from the latest checkpoint, excluding dead
hosts via a smaller data-parallel degree — see elastic.py).
"""
from __future__ import annotations

import collections
import signal
import threading
import time
from typing import Callable, Optional

from repro_torch.obs.events import emit_event
from repro_torch.utils.logging import get_logger

log = get_logger("fault")


class StepWatchdog:
    """Flags steps slower than ``trip_factor`` x the rolling median.

    On a real fleet the callback reports the straggling host to the control
    plane (to exclude on restart); here it logs and counts.
    """

    def __init__(self, window: int = 50, trip_factor: float = 3.0,
                 on_trip: Optional[Callable[[int, float, float], None]] = None):
        self.times = collections.deque(maxlen=window)
        self.trip_factor = trip_factor
        self.on_trip = on_trip
        self.trips = 0
        self._t0: Optional[float] = None

    def start_step(self) -> None:
        self._t0 = time.monotonic()

    def end_step(self, step: int) -> float:
        assert self._t0 is not None
        dt = time.monotonic() - self._t0
        if len(self.times) >= 10:
            med = sorted(self.times)[len(self.times) // 2]
            if dt > self.trip_factor * med:
                self.trips += 1
                log.warning(
                    "straggler tripwire: step %d took %.3fs (median %.3fs)",
                    step, dt, med,
                )
                emit_event("watchdog_trip", step=step, dt_s=dt, median_s=med,
                           trip_factor=self.trip_factor, trips=self.trips)
                if self.on_trip:
                    self.on_trip(step, dt, med)
        self.times.append(dt)
        self._t0 = None
        return dt


class PreemptionHandler:
    """SIGTERM/SIGINT -> set a flag; the train loop checkpoints and exits 0.

    The fleet scheduler interprets a clean exit after preemption as
    "restartable"; the auto-restart wrapper then resumes from the last step.
    """

    def __init__(self, signals=(signal.SIGTERM,)):
        self._flag = threading.Event()
        self._signals = signals
        self._installed = False
        self._previous: dict = {}

    def install(self) -> "PreemptionHandler":
        if not self._installed:
            for sig in self._signals:
                try:
                    self._previous[sig] = signal.signal(sig, self._handle)
                except ValueError:
                    pass  # non-main thread (tests)
            self._installed = True
        return self

    def uninstall(self) -> None:
        """Restore the dispositions ``install`` replaced.

        The train loop calls this on the way out so a later SIGTERM hits
        whatever the host process had installed — not a stale flag on a
        handler whose run already exited (matters for in-process
        ``--auto-restart`` attempts and for test runners).
        """
        if self._installed:
            for sig, prev in self._previous.items():
                try:
                    signal.signal(sig, prev)
                except ValueError:
                    pass
            self._previous = {}
            self._installed = False

    def _handle(self, signum, frame):
        log.warning("received signal %s: requesting graceful stop", signum)
        self._flag.set()

    def preempted(self) -> bool:
        return self._flag.is_set()

    def request_stop(self) -> None:  # testable without real signals
        self._flag.set()


def retry(fn: Callable, *, attempts: int = 3, backoff_s: float = 1.0,
          retriable=(OSError, IOError)):
    """Retry transient host-side failures (checkpoint IO, rendezvous)."""
    last = None
    for i in range(attempts):
        try:
            return fn()
        except retriable as e:  # noqa: PERF203
            last = e
            log.warning("attempt %d/%d failed: %s", i + 1, attempts, e)
            time.sleep(backoff_s * (2**i))
    raise last
