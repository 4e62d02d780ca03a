"""repro_torch.obs (port of ``repro.obs``) — low-overhead observability:
metrics stream, lifecycle events, profiler trace capture.

Three pieces:

* ``sinks`` — the ``MetricsSink`` protocol (JSONL-file / in-memory / null)
  plus the process-wide stream registry.  The default sink is inert, so
  instrumented library code costs nothing until a driver calls
  ``configure_run(run_dir)``.
* ``events`` — the closed lifecycle-event taxonomy (``EVENT_KINDS``) and
  the ``emit_event``/``emit_metrics`` stamping layer (run_id/rank/seq).
* ``profile``/``timeline`` — ``--profile-steps N:M`` trace capture with
  ``torch.profiler`` and the stdlib-only extraction of per-step wall times
  (and, on the card, per-step kernel time) from the written trace.

``python -m repro_torch.obs RUN_DIR`` renders a run's streams into a summary.
"""
from repro_torch.obs.events import (
    EVENT_KINDS,
    configure_run,
    emit_event,
    emit_metrics,
    events_active,
    flush_all,
    metrics_active,
)
from repro_torch.obs.profile import ProfileWindow
from repro_torch.obs.report import render_text, summarize_run
from repro_torch.obs.sinks import (
    JsonlSink,
    MemorySink,
    MetricsSink,
    NullSink,
    get_sink,
    read_jsonl,
    reset_sinks,
    set_sink,
)

__all__ = [
    "EVENT_KINDS",
    "JsonlSink",
    "MemorySink",
    "MetricsSink",
    "NullSink",
    "ProfileWindow",
    "configure_run",
    "emit_event",
    "emit_metrics",
    "events_active",
    "flush_all",
    "get_sink",
    "metrics_active",
    "read_jsonl",
    "render_text",
    "reset_sinks",
    "set_sink",
    "summarize_run",
]
