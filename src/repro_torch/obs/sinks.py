"""Metric/event sinks (a copy of ``obs/sinks.py``): where observability
records go, at what cost.

The contract is deliberately tiny — ``emit(record)`` with JSON-able dicts —
so instrumentation points stay one-liners and the cost model is explicit:

* ``NullSink`` (the default for every stream) is inert: ``active`` is False
  and instrumentation sites are expected to check it BEFORE building a
  record, so an un-instrumented run does zero extra work — no host
  transfers, no string formatting, no epsilon computation.
* ``JsonlSink`` appends one ``json.dumps`` line per record to a file opened
  in append mode and flushes after each write.  Append-only by
  construction: the file is never seeked, truncated, or rewritten, so
  concurrent readers (and post-crash forensics) always see a prefix of the
  true record stream.  Emission is serialized by a lock — the checkpoint
  manager emits from its async writer thread.
* ``MemorySink`` collects records in a list (tests, in-process dashboards).

``read_jsonl`` is the matching reader: it tolerates a crash-torn final
line (a process killed mid-``write``) by skipping any line that fails to
parse, mirroring the checkpoint manager's fall-back-past-torn-artifacts
policy — a damaged tail costs one record, never the stream.

The process-wide registry maps stream names (``"metrics"``, ``"events"``)
to sinks so deep emit points (watchdog, injector, consensus, queue) need no
plumbing: they ask ``get_sink(stream)`` and check ``.active``.
"""
from __future__ import annotations

import json
import pathlib
import threading
from typing import Any, Optional, Protocol, runtime_checkable


@runtime_checkable
class MetricsSink(Protocol):
    """Destination for one stream of JSON-able records."""

    active: bool

    def emit(self, record: dict) -> None: ...

    def flush(self) -> None: ...

    def close(self) -> None: ...


class NullSink:
    """Inert sink: ``active=False`` so emit sites skip record-building."""

    active = False

    def emit(self, record: dict) -> None:  # pragma: no cover - never called
        pass

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


class MemorySink:
    """In-memory sink (tests, notebooks): records accumulate in ``records``."""

    active = True

    def __init__(self):
        self.records: list[dict] = []
        self._lock = threading.Lock()

    def emit(self, record: dict) -> None:
        with self._lock:
            self.records.append(dict(record))

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


class JsonlSink:
    """Append-only JSONL file sink; one flushed line per record.

    The file handle opens lazily (on the first emit) in ``"a"`` mode, so
    constructing a sink for a directory that does not exist yet is safe and
    in-process restarts APPEND to the same stream instead of clobbering the
    pre-crash records — the post-mortem timeline stays whole.  Open also
    self-heals a crash-torn tail: if the existing file does not end in a
    newline (the previous process died mid-write), a newline is appended
    first so the next record starts on its own line instead of gluing onto
    the torn fragment and being lost with it.
    """

    active = True

    def __init__(self, path):
        self.path = pathlib.Path(path)
        self._fh = None
        self._lock = threading.Lock()

    def emit(self, record: dict) -> None:
        line = json.dumps(record, sort_keys=True, default=str)
        with self._lock:
            if self._fh is None:
                self.path.parent.mkdir(parents=True, exist_ok=True)
                terminate = False
                try:
                    with self.path.open("rb") as fh:
                        fh.seek(-1, 2)
                        terminate = fh.read(1) != b"\n"
                except OSError:
                    pass  # missing or empty file: nothing to heal
                self._fh = self.path.open("a", encoding="utf-8")
                if terminate:
                    self._fh.write("\n")
            self._fh.write(line + "\n")
            self._fh.flush()

    def flush(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.flush()

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None


def read_jsonl(path) -> list[dict]:
    """Parse a JSONL stream, skipping torn lines.

    A process crashing mid-write leaves a final line that is a prefix of a
    JSON document (``runtime.inject``'s ``torn@step`` injector manufactures
    exactly this); any line that fails to parse — torn tail or interleaved
    garbage — is dropped rather than failing the whole read.
    """
    p = pathlib.Path(path)
    if not p.exists():
        return []
    out: list[dict] = []
    for line in p.read_text(encoding="utf-8", errors="replace").splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            continue  # torn write: a prefix of a record, never a record
        if isinstance(rec, dict):
            out.append(rec)
    return out


# -- process-wide registry -------------------------------------------------
_NULL = NullSink()
_SINKS: dict[str, Any] = {}
_REG_LOCK = threading.Lock()


def get_sink(stream: str):
    """The sink for ``stream`` (``NullSink`` when none is installed)."""
    return _SINKS.get(stream, _NULL)


def set_sink(stream: str, sink: Optional[Any]):
    """Install (or with ``None``, remove) the sink for ``stream``.

    Returns the previous sink (callers may restore it); the previous sink
    is NOT closed — tests swap ``MemorySink``s in and out freely.
    """
    with _REG_LOCK:
        prev = _SINKS.get(stream)
        if sink is None:
            _SINKS.pop(stream, None)
        else:
            _SINKS[stream] = sink
        return prev


def reset_sinks() -> None:
    """Close and remove every installed sink (test isolation, run teardown)."""
    with _REG_LOCK:
        for sink in _SINKS.values():
            try:
                sink.close()
            except OSError:  # pragma: no cover - best-effort teardown
                pass
        _SINKS.clear()
