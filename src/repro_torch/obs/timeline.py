"""Extract per-step wall times from a captured profiler trace (port of
``obs/timeline.py``).

``repro_torch.obs.profile.ProfileWindow`` writes Chrome-trace JSON
(``traceEvents``: complete events with ``ph="X"``, ``ts``/``dur`` in
microseconds) under ``<run_dir>/profile/``; a ``*.trace.json.gz`` is read
too.  This module reads those files with the stdlib only.

The JAX matcher keys on XLA's events (``StepMarker``, ``XlaModule``,
``TfrtCpuExecutable::Execute``), which ``torch.profiler`` never writes.  The
port's matcher keys on what its own train loop marks: one
``record_function`` span per step (``train_step#<step>``), or the
profiler's own ``ProfilerStep#<n>``.  Each such span is in the trace twice
on the card: on the host thread (category ``user_annotation``) and on the
GPU stream (``gpu_user_annotation``, from the first to the last kernel the
step launched).  ``device=False`` selects the host spans, ``device=True``
the GPU ones; ``step_kernel_ms`` sums the CUDA kernel events inside each
GPU span.  The grouping of ``step_wall_times_ms`` is the JAX package's.
"""
from __future__ import annotations

import gzip
import json
import pathlib
import re
from typing import Iterable, Optional

DEFAULT_STEP_PATTERN = r"^(train_step|ProfilerStep)#\d+$"
# the GPU stream's copy of a record_function span; events without a
# category (or any other) are the host's
DEVICE_CATEGORIES = ("gpu_user_annotation",)
KERNEL_CATEGORY = "kernel"


def trace_files(trace_dir) -> list[pathlib.Path]:
    """Every ``*.trace.json[.gz]`` under ``trace_dir``, sorted for determinism."""
    root = pathlib.Path(trace_dir)
    if not root.exists():
        return []
    return sorted(
        p for p in root.rglob("*")
        if p.is_file() and (
            p.name.endswith(".trace.json.gz") or p.name.endswith(".trace.json")
        )
    )


def load_trace_events(trace_dir) -> list[dict]:
    """All Chrome-trace ``traceEvents`` from every trace file, ``ts``-ordered."""
    events: list[dict] = []
    for path in trace_files(trace_dir):
        raw = path.read_bytes()
        if path.name.endswith(".gz"):
            raw = gzip.decompress(raw)
        payload = json.loads(raw)
        evs = payload.get("traceEvents", payload if isinstance(payload, list) else [])
        events.extend(e for e in evs if isinstance(e, dict))
    events.sort(key=lambda e: float(e.get("ts", 0.0)))
    return events


def _is_device(event: dict) -> bool:
    return event.get("cat") in DEVICE_CATEGORIES


def execution_spans(
    trace_dir, pattern: str = DEFAULT_STEP_PATTERN, device: bool = False,
    events: Optional[list[dict]] = None,
) -> list[dict]:
    """Complete (``ph="X"``) events whose name matches ``pattern``, on the
    GPU stream (``device=True``) or the host's.

    Returns ``[{"name", "ts_us", "dur_us"}, ...]`` in timestamp order —
    the raw material for per-step wall times.  ``events`` (already loaded)
    spares a second read of the trace.
    """
    rx = re.compile(pattern)
    out = []
    for e in load_trace_events(trace_dir) if events is None else events:
        name = str(e.get("name", ""))
        if e.get("ph") == "X" and rx.search(name) and _is_device(e) == device:
            out.append({
                "name": name,
                "ts_us": float(e.get("ts", 0.0)),
                "dur_us": float(e.get("dur", 0.0)),
            })
    return out


def step_wall_times_ms(
    trace_dir,
    pattern: str = DEFAULT_STEP_PATTERN,
    group_us: Optional[float] = None,
    device: bool = False,
) -> list[float]:
    """Per-step wall times (ms) from the trace's execution spans.

    Consecutive spans separated by less than ``group_us`` of idle gap are
    folded into one step (an accumulation loop is several executions per
    logical batch); ``group_us=None`` derives the threshold as half the
    median inter-span gap, which cleanly splits back-to-back microsteps
    from the between-step host work in practice.  Each step's wall time is
    last-span-end minus first-span-start.
    """
    spans = execution_spans(trace_dir, pattern, device=device)
    if not spans:
        return []
    if len(spans) == 1:
        return [spans[0]["dur_us"] / 1e3]
    gaps = [
        max(0.0, b["ts_us"] - (a["ts_us"] + a["dur_us"]))
        for a, b in zip(spans, spans[1:])
    ]
    if group_us is None:
        ordered = sorted(gaps)
        group_us = ordered[len(ordered) // 2] / 2.0
    steps: list[list[dict]] = [[spans[0]]]
    for gap, span in zip(gaps, spans[1:]):
        if gap <= group_us:
            steps[-1].append(span)
        else:
            steps.append([span])
    out = []
    for group in steps:
        start = group[0]["ts_us"]
        end = max(s["ts_us"] + s["dur_us"] for s in group)
        out.append((end - start) / 1e3)
    return out


def step_kernel_ms(trace_dir, pattern: str = DEFAULT_STEP_PATTERN) -> list[dict]:
    """Per GPU step span: its name, its length (``span_ms``), and the CUDA
    kernels that start inside it, counted (``kernels``) and summed
    (``kernel_ms``: the device's busy time in the step where kernels do not
    overlap).  Empty for a trace without CUDA activity."""
    events = load_trace_events(trace_dir)
    kernels = [e for e in events
               if e.get("ph") == "X" and e.get("cat") == KERNEL_CATEGORY]
    out = []
    for span in execution_spans(trace_dir, pattern, device=True, events=events):
        lo, hi = span["ts_us"], span["ts_us"] + span["dur_us"]
        inside = [float(k.get("dur", 0.0)) for k in kernels
                  if lo <= float(k.get("ts", 0.0)) < hi]
        out.append({"name": span["name"], "span_ms": span["dur_us"] / 1e3,
                    "kernels": len(inside), "kernel_ms": sum(inside) / 1e3})
    return out


def percentile(xs: Iterable[float], q: float) -> float:
    """Nearest-rank percentile (mirrors serving.engine's aggregation)."""
    s = sorted(xs)
    if not s:
        return 0.0
    i = min(len(s) - 1, max(0, int(round(q * (len(s) - 1)))))
    return s[i]
