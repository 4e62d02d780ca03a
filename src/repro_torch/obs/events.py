"""Structured lifecycle events + the metrics stream: one emit API (port of
``obs/events.py``).

Every record — event or metric — is stamped with the run context
(``run_id``, ``rank``), a process-monotone sequence number, and a wall
clock, then handed to the registered sink for its stream
(``repro_torch.obs.sinks``).  The default sink is inert, so library code may
emit unconditionally-guarded one-liners::

    from repro_torch.obs import events as obs

    obs.emit_event("watchdog_trip", step=step, dt_s=dt, median_s=med)

and pay nothing until a driver calls ``configure_run(run_dir)`` — which
installs append-only JSONL sinks for both streams next to ``summary.json``
(``events.jsonl`` / ``metrics.jsonl``).

The event taxonomy is CLOSED (``EVENT_KINDS``): an unknown kind raises at
the emit site, so the set of things that can appear in ``events.jsonl`` is
reviewable here rather than discovered by grepping consumers.

This module never imports torch (the ``python -m repro_torch.obs`` reader
parses record files offline); the rank stamp is therefore resolved lazily
from ``sys.modules`` like ``utils/logging``, and is 0 until a
``torch.distributed`` process group is initialised.
"""
from __future__ import annotations

import itertools
import os
import sys
import threading
import time
from typing import Optional

from repro_torch.obs.sinks import JsonlSink, get_sink, reset_sinks, set_sink
from repro_torch.utils.logging import get_logger

log = get_logger("obs")

# the closed event taxonomy (the JAX package's)
EVENT_KINDS = (
    "run_started",        # launcher entry: arch/mode/policy/batch layout
    "plan_adopted",       # ClipPlan (or analytic fallback) chosen: per-tap
    #                       branch maps + kernel winners + batch certificate
    "checkpoint_saved",   # manager: artifact durably written + rotated
    "checkpoint_restored",  # manager: restore() succeeded at a step
    "watchdog_trip",      # StepWatchdog: step slower than trip_factor*median
    "preemption",         # SIGTERM observed -> checkpoint-and-exit path
    "restart_attempt",    # --auto-restart supervisor retrying after a crash
    "fault_injected",     # runtime.inject fired a deterministic fault
    "consensus_agreed",   # fleet adopted one plan (hash, ranks, leader)
    "consensus_rejected",  # PlanConsensusError: fleet must not trace
    "request_shed",       # serving admission: projected TTFT blew the SLO
    "profile_started",    # torch.profiler trace window opened
    "profile_stopped",    # trace window closed (trace_dir recorded)
    "epsilon_budget_crossed",  # accountant passed the configured fraction of
    #                       the target epsilon (one-shot per run)
    "run_finished",       # launcher exit: final step + privacy spend
)

_SEQ = itertools.count()
_CONTEXT = {"run_id": None}
_CONF_LOCK = threading.Lock()

EVENTS_FILENAME = "events.jsonl"
METRICS_FILENAME = "metrics.jsonl"


def _rank() -> int:
    """This process's rank in the ``torch.distributed`` group, without
    importing torch or initialising a group: 0 when none is initialised
    (single-process runs and the offline readers)."""
    dist = sys.modules.get("torch.distributed")
    if dist is None:
        return 0
    try:
        if dist.is_available() and dist.is_initialized():
            return int(dist.get_rank())
    except (RuntimeError, ValueError):  # a group torn down mid-record
        return 0
    return 0


def set_run_context(run_id: Optional[str]) -> None:
    _CONTEXT["run_id"] = run_id


def run_context() -> dict:
    return {"run_id": _CONTEXT["run_id"], "rank": _rank()}


def configure_run(run_dir, run_id: Optional[str] = None) -> Optional[str]:
    """Point both streams at ``run_dir`` (append-only JSONL files).

    ``run_dir=None`` resets to the inert default — drivers call this
    unconditionally so a run without an obs/checkpoint directory cannot
    inherit a previous in-process run's sinks (test isolation).

    Reconfiguring for the SAME directory keeps the existing sinks and
    ``run_id``: in-process ``--auto-restart`` attempts append to one
    stream, so the post-mortem timeline spans every attempt.  Returns the
    effective run id.
    """
    with _CONF_LOCK:
        if run_dir is None:
            reset_sinks()
            _CONTEXT["run_id"] = None
            return None
        import pathlib

        run_dir = pathlib.Path(run_dir)
        existing = get_sink("events")
        if (
            isinstance(existing, JsonlSink)
            and existing.path == run_dir / EVENTS_FILENAME
        ):
            return _CONTEXT["run_id"]  # same run: keep appending
        reset_sinks()
        set_sink("events", JsonlSink(run_dir / EVENTS_FILENAME))
        set_sink("metrics", JsonlSink(run_dir / METRICS_FILENAME))
        if run_id is None:
            run_id = f"run-{int(time.time())}-{os.getpid()}"
        _CONTEXT["run_id"] = run_id
        return run_id


def _stamp(record: dict, step: Optional[int]) -> dict:
    out = {
        "run_id": _CONTEXT["run_id"],
        "rank": _rank(),
        "seq": next(_SEQ),
        "t": time.time(),
    }
    if step is not None:
        out["step"] = int(step)
    out.update(record)
    return out


def events_active() -> bool:
    return get_sink("events").active


def metrics_active() -> bool:
    return get_sink("metrics").active


_RESERVED_FIELDS = frozenset({"run_id", "rank", "seq", "t", "step", "kind"})


def emit_event(kind: str, *, step: Optional[int] = None, **fields) -> None:
    """Append one lifecycle event to the events stream (no-op when inert)."""
    if kind not in EVENT_KINDS:
        raise ValueError(
            f"unknown event kind {kind!r}; add it to repro_torch.obs.events."
            f"EVENT_KINDS (known: {', '.join(EVENT_KINDS)})"
        )
    clash = _RESERVED_FIELDS.intersection(fields)
    if clash:
        raise ValueError(
            f"event field(s) {sorted(clash)} collide with the record stamp; "
            "rename them (e.g. seq -> seq_len)"
        )
    sink = get_sink("events")
    if not sink.active:
        return
    sink.emit(_stamp({"kind": kind, **fields}, step))


def emit_metrics(record: dict, *, step: Optional[int] = None) -> None:
    """Append one metrics record (e.g. kind="train_step") to the stream.

    Callers must gate any host-side value materialization on
    ``metrics_active()`` — this function only stamps and forwards.
    """
    sink = get_sink("metrics")
    if not sink.active:
        return
    sink.emit(_stamp(dict(record), step))


def flush_all() -> None:
    for stream in ("events", "metrics"):
        get_sink(stream).flush()
