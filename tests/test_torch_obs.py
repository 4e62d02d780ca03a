"""repro_torch.obs against the JAX package's repro.obs: the event and
metrics streams, the run summary, the trace timeline, the profiler window,
the epsilon alarm, and the train loop's sync count with obs on and off.

Counterparts of ``tests/test_obs.py``.  The pure parts take the same inputs
in both packages and must agree exactly: ``summarize_run`` and
``render_text`` on one run directory written through either package's
emitters, ``step_wall_times_ms``'s grouping on one synthetic trace, and the
one-shot epsilon alarm's step and record.  ``ProfileWindow`` captures a real
``torch.profiler`` trace on the CPU (its JAX counterpart needs a profiler
this CPU build lacks).  The train loop's one host sync per logical batch
(``launch.train.host_metrics``) is counted with the metrics stream off and
on: equal, one per step, the counterpart of the JAX test counting
``block_until_ready``.
"""
from __future__ import annotations

import gzip
import json
import logging
import sys

import pytest

from repro.core.engine import PrivacyEngine as JPrivacyEngine
from repro.obs import events as jevents
from repro.obs import report as jreport
from repro.obs import sinks as jsinks
from repro.obs import timeline as jtimeline
from repro_torch.obs import (
    EVENT_KINDS,
    JsonlSink,
    MemorySink,
    configure_run,
    emit_event,
    emit_metrics,
    events_active,
    read_jsonl,
    reset_sinks,
    set_sink,
    summarize_run,
)
from repro_torch.obs import events as obs_events
from repro_torch.obs import sinks as tsinks
from repro_torch.obs.profile import ProfileWindow, parse_window
from repro_torch.obs.report import render_text
from repro_torch.obs.timeline import (
    execution_spans,
    percentile,
    step_kernel_ms,
    step_wall_times_ms,
)
from repro_torch.runtime.inject import InjectionPlan, tear_file
from torch_threads import torch_threads_per_worker  # noqa: F401

ARCH = ["--arch", "yi-6b", "--reduced", "--device", "cpu", "--seq", "8", "--log-every", "4"]


@pytest.fixture(autouse=True)
def _inert_sinks():
    reset_sinks()
    jsinks.reset_sinks()
    yield
    reset_sinks()
    jsinks.reset_sinks()


def _mem_sinks():
    ev, mt = MemorySink(), MemorySink()
    set_sink("events", ev)
    set_sink("metrics", mt)
    return ev, mt


# -- sinks + stamping ------------------------------------------------------
def test_event_kinds_and_stamp_match_jax():
    assert EVENT_KINDS == jevents.EVENT_KINDS
    assert obs_events._RESERVED_FIELDS == jevents._RESERVED_FIELDS
    assert not events_active()
    emit_event("run_started", arch="x")  # inert: no raise
    emit_metrics({"kind": "train_step"})
    with pytest.raises(ValueError, match="unknown event kind"):
        emit_event("made_up_kind")
    ev, _ = _mem_sinks()
    with pytest.raises(ValueError, match="collide"):
        emit_event("run_started", seq=16)
    obs_events.set_run_context("run-test")
    emit_event("run_started", arch="a")
    emit_event("run_finished", step=3, epsilon=1.0)
    a, b = ev.records
    assert a["run_id"] == "run-test" and a["rank"] == 0 and "t" in a
    assert b["step"] == 3 and b["seq"] > a["seq"]


def test_jsonl_sink_appends_and_survives_torn_tail(tmp_path):
    path = tmp_path / "events.jsonl"
    sink = JsonlSink(path)
    sink.emit({"kind": "a", "n": 1})
    sink.emit({"kind": "b", "n": 2})
    sink.close()
    tear_file(path)
    torn = path.read_text().splitlines()
    assert read_jsonl(path) == [] == jsinks.read_jsonl(path)
    sink2 = JsonlSink(path)
    sink2.emit({"kind": "c", "n": 3})
    sink2.close()
    assert [r["kind"] for r in read_jsonl(path)] == ["c"]
    assert path.read_text().splitlines()[0] == torn[0]
    p = tmp_path / "m.jsonl"
    p.write_text('{"ok": 1}\nnot json\n[1,2]\n{"ok": 2}\n')
    assert read_jsonl(p) == jsinks.read_jsonl(p) == [{"ok": 1}, {"ok": 2}]


def test_configure_run_same_dir_keeps_stream_none_resets(tmp_path):
    rid = configure_run(tmp_path)
    assert rid and events_active()
    emit_event("run_started")
    assert configure_run(tmp_path) == rid
    emit_event("run_finished")
    assert [r["kind"] for r in read_jsonl(tmp_path / "events.jsonl")] == [
        "run_started", "run_finished"]
    assert configure_run(None) is None and not events_active()


# -- emit points in the runtime --------------------------------------------
def test_runtime_emit_points(tmp_path):
    """The watchdog's trip, an injected fault and the checkpoint manager's
    save and restore land in the events stream."""
    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.runtime.fault import StepWatchdog

    ev, _ = _mem_sinks()
    wd = StepWatchdog(trip_factor=3.0)
    wd.times.extend([0.01] * 10)
    wd.start_step()
    wd._t0 -= 1.0
    wd.end_step(7)
    InjectionPlan.from_spec("slow@1:0", env="").on_step(1)
    mgr = CheckpointManager(str(tmp_path), save_every=1, async_save=False)
    mgr.save(1, {"w": torch.ones(2)}, force=True)
    step, _ = mgr.restore()
    kinds = [r["kind"] for r in ev.records]
    assert kinds == ["watchdog_trip", "fault_injected", "checkpoint_saved",
                     "checkpoint_restored"]
    trip, fault, saved, restored = ev.records
    assert trip["step"] == 7 and trip["dt_s"] > trip["median_s"]
    assert fault["spec"] == "slow@1:0"
    assert saved["path"].endswith("step_1.npz") and saved["bytes"] > 0
    assert restored["step"] == 1 and restored["restore_s"] >= 0


def test_queue_shed_event_matches_jax():
    from repro.serving.queue import LatencyModel as JLatencyModel
    from repro.serving.queue import Request as JRequest
    from repro.serving.queue import RequestQueue as JRequestQueue
    from repro_torch.serving.queue import LatencyModel, Request, RequestQueue

    records = []
    for latency, request, queue_cls, sinks in (
            (LatencyModel, Request, RequestQueue, tsinks),
            (JLatencyModel, JRequest, JRequestQueue, jsinks)):
        ev = MemorySink()
        sinks.set_sink("events", ev)
        q = queue_cls(latency())
        q.model.observe_prefill(10, 1.0)
        q.model.observe_step(0.05)
        assert not q.offer(request(rid=7, tokens=[1] * 20, slo_ttft_ms=100.0),
                           free_slots=1, active_remaining=[])
        (rec,) = ev.records
        records.append({k: v for k, v in rec.items() if k not in ("t", "seq", "run_id")})
        assert q.stats()["shed_total"] == 1
    assert records[0] == records[1]
    assert records[0]["kind"] == "request_shed" and records[0]["projected_ttft_ms"] > 100


def test_serve_cli_obs_dir(tmp_path):
    """``--obs-dir`` on the serve CLI: run events and one serving_step
    record per engine step, read back by summarize_run."""
    from repro_torch.launch import serve

    d = tmp_path / "serve"
    assert serve.main(["--arch", "yi-6b", "--reduced", "--device", "cpu", "--requests", "2",
                       "--slots", "2", "--prompt-len", "4", "--max-new", "3",
                       "--obs-dir", str(d)]) == 0
    s = summarize_run(d)
    assert s["events"] == {"run_finished": 1, "run_started": 1}
    assert s["serving_steps"] >= 2 and s["last_serving"]["shed_total"] == 0


def test_serve_batched_example_runs_on_the_cpu(capsys):
    """``examples/serve_batched_torch.py --reduced --device cpu`` drains its
    request stream through the port's ``Engine``."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "examples" / "serve_batched_torch.py"
    spec = importlib.util.spec_from_file_location("serve_batched_torch", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    assert example.main(["--reduced", "--device", "cpu", "--requests", "3",
                         "--max-new", "3"]) == 0
    out = capsys.readouterr().out
    assert "3 served / 0 shed" in out and "on cpu" in out


# -- train-loop integration ------------------------------------------------
def _count_syncs(monkeypatch, argv):
    from repro_torch.launch import train

    real = train.host_metrics
    calls = {"n": 0}

    def counting(metrics):
        calls["n"] += 1
        return real(metrics)

    monkeypatch.setattr(train, "host_metrics", counting)
    try:
        assert train.main(argv) == 0
    finally:
        monkeypatch.setattr(train, "host_metrics", real)
    return calls["n"]


def test_instrumentation_adds_no_host_sync(tmp_path, monkeypatch):
    """With the metrics stream on, the accumulation loop makes exactly the
    host syncs it makes with it off: one per logical batch, the metrics
    riding it."""
    base = ARCH + ["--steps", "3", "--batch", "4", "--data-shards", "2"]
    plain = _count_syncs(monkeypatch, list(base))
    obs_dir = tmp_path / "obs"
    instrumented = _count_syncs(monkeypatch, base + ["--obs-dir", str(obs_dir)])
    assert plain == instrumented == 3
    train = [m for m in read_jsonl(obs_dir / "metrics.jsonl") if m["kind"] == "train_step"]
    assert [m["step"] for m in train] == [1, 2, 3]
    assert all(m["accumulation_steps"] == 2 and m["physical_batch"] == 2 for m in train)
    assert all(m["epsilon"] > 0 for m in train)
    assert all(m["norm_max"] >= m["norm_mean"] > 0 for m in train)


def test_events_survive_auto_restart_and_profile(tmp_path):
    """One stream spans a crash and its restart (monotone seq and steps, one
    run_id), and ``--profile-steps 1:2`` writes a trace with one step span
    per profiled step that ``python -m repro_torch.obs --timeline`` reads."""
    from repro_torch.launch.train import main
    from repro_torch.obs.__main__ import main as cli

    d = tmp_path / "run"
    assert main(ARCH + ["--ckpt-dir", str(d), "--steps", "4", "--batch", "2",
                        "--ckpt-every", "2", "--auto-restart", "2", "--fail-at-step", "3",
                        "--profile-steps", "1:2"]) == 0
    events = read_jsonl(d / "events.jsonl")
    kinds = [e["kind"] for e in events]
    assert kinds.count("run_started") == 2 and kinds.count("plan_adopted") == 2
    for kind in ("fault_injected", "restart_attempt", "checkpoint_restored",
                 "profile_started", "profile_stopped"):
        assert kind in kinds, kind
    assert kinds[-1] == "run_finished"
    seqs = [e["seq"] for e in events]
    assert seqs == sorted(seqs) and len(set(seqs)) == len(seqs)
    steps = [m["step"] for m in read_jsonl(d / "metrics.jsonl") if m["kind"] == "train_step"]
    assert steps == [1, 2, 3, 4]
    assert len({e["run_id"] for e in events}) == 1
    spans = execution_spans(d / "profile")
    assert [s["name"] for s in spans] == ["train_step#1", "train_step#2"]
    assert len(step_wall_times_ms(d / "profile", group_us=0.0)) == 2
    assert step_kernel_ms(d / "profile") == []  # no CUDA activity on the CPU
    assert cli([str(d), "--timeline"]) == 0


# -- profiler window + timeline --------------------------------------------
def test_parse_window():
    assert parse_window("3:5") == (3, 5) and parse_window("4") == (4, 4)
    with pytest.raises(ValueError, match="N or N:M"):
        parse_window("a:b")
    with pytest.raises(ValueError, match="0 <= N <= M"):
        parse_window("5:3")


def test_profile_window_captures_real_trace(tmp_path):
    import torch

    ev, _ = _mem_sinks()
    win = ProfileWindow(0, 1, tmp_path / "profile")
    x = torch.ones((32, 32))
    for step in range(3):
        win.before_step(step)
        with win.span(step):
            (x @ x).sum().item()
        win.after_step(step)
    assert win.done and not win.active and win.trace_path.exists()
    kinds = [r["kind"] for r in ev.records]
    assert kinds == ["profile_started", "profile_stopped"]
    spans = execution_spans(tmp_path / "profile")
    assert [s["name"] for s in spans] == ["train_step#0", "train_step#1"]
    assert step_wall_times_ms(tmp_path / "profile")


def _write_trace(root, events, gz=True):
    d = root / "plugins" / "profile" / "2026"
    d.mkdir(parents=True)
    payload = json.dumps({"traceEvents": events}).encode()
    if gz:
        (d / "host.trace.json.gz").write_bytes(gzip.compress(payload))
    else:
        (d / "host.trace.json").write_bytes(payload)


def test_timeline_grouping_matches_jax(tmp_path):
    """One synthetic trace (an accumulation step of two spans, 5 ms of host
    work, a second step; noise events) grouped by both packages' code under
    one pattern: equal spans and equal step times for every threshold."""
    name = "train_step#0"
    _write_trace(tmp_path, [
        {"ph": "X", "name": name, "ts": 0, "dur": 100},
        {"ph": "X", "name": name, "ts": 110, "dur": 100},
        {"ph": "X", "name": "train_step#1", "ts": 5210, "dur": 300},
        {"ph": "X", "name": "HostLoopOverhead", "ts": 50, "dur": 10},
        {"ph": "B", "name": name, "ts": 60},
    ])
    pattern = r"^train_step#\d+$"
    assert execution_spans(tmp_path, pattern) == jtimeline.execution_spans(tmp_path, pattern)
    for group_us in (None, 0.0, 5.0, 1000.0, 1e9):
        assert step_wall_times_ms(tmp_path, pattern, group_us) == \
            jtimeline.step_wall_times_ms(tmp_path, pattern, group_us)
    assert step_wall_times_ms(tmp_path, group_us=1000.0) == pytest.approx([0.21, 0.3])
    assert percentile([3.0, 1.0, 2.0], 0.5) == jtimeline.percentile([3.0, 1.0, 2.0], 0.5)


def test_timeline_reads_device_spans_and_kernels(tmp_path):
    """On a CUDA trace each step span is there twice: the host's and the GPU
    stream's; ``device=True`` takes the latter, and ``step_kernel_ms`` sums
    the kernels inside each."""
    _write_trace(tmp_path, [
        {"ph": "X", "cat": "user_annotation", "name": "train_step#2", "ts": 0, "dur": 900},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "train_step#2", "ts": 100,
         "dur": 1000},
        {"ph": "X", "cat": "kernel", "name": "gemm", "ts": 100, "dur": 400},
        {"ph": "X", "cat": "kernel", "name": "ghost_norm", "ts": 600, "dur": 300},
        {"ph": "X", "cat": "kernel", "name": "later", "ts": 2000, "dur": 50},
    ], gz=False)
    assert [s["dur_us"] for s in execution_spans(tmp_path)] == [900]
    assert [s["dur_us"] for s in execution_spans(tmp_path, device=True)] == [1000]
    assert step_wall_times_ms(tmp_path, device=True) == [1.0]
    assert step_kernel_ms(tmp_path) == [
        {"name": "train_step#2", "span_ms": 1.0, "kernels": 2, "kernel_ms": 0.7}]


# -- report + CLI ----------------------------------------------------------
def _fake_run_dir(tmp_path, pkg_events):
    pkg_events.configure_run(tmp_path, run_id="run-x")
    pkg_events.emit_event("run_started", arch="yi-6b")
    pkg_events.emit_event(
        "plan_adopted", mode="mixed_ghost", policy="fixed", source="plan",
        physical_batch=2, accumulation_steps=2, branches={"f1": "ghost"},
        kernels={"f1": {"fwd": "cuda"}})
    for i, (eps, dt) in enumerate([(0.1, 0.2), (0.2, 0.3), (0.3, 0.25)]):
        pkg_events.emit_metrics({"kind": "train_step", "loss": 1.0, "lr": 1e-3,
                                 "clip_frac": 0.5, "epsilon": eps, "delta": 1e-5,
                                 "step_s": dt, "examples_per_s": 4 / dt}, step=i + 1)
    pkg_events.emit_event("restart_attempt", attempt=1, max_attempts=2, error="x")
    pkg_events.emit_event("run_finished", step=3, epsilon=0.3, delta=1e-5)
    pkg_events.configure_run(None)
    return tmp_path


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_summarize_and_render_match_jax(tmp_path, writer):
    d = _fake_run_dir(tmp_path, obs_events if writer == "port" else jevents)
    s = summarize_run(d)
    assert s == jreport.summarize_run(d)
    assert render_text(s) == jreport.render_text(s)
    assert s["epsilon_trajectory"] == [(1, 0.1), (2, 0.2), (3, 0.3)]
    assert s["restarts"] == 1 and s["run_ids"] == ["run-x"]
    assert "tap f1: branch=ghost kernels[fwd=cuda]" in render_text(s)


def test_obs_cli_json_and_epsilon_gate(tmp_path, capsys):
    from repro_torch.obs.__main__ import main as cli

    d = _fake_run_dir(tmp_path / "good", obs_events)
    assert cli([str(d), "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["final_epsilon"] == 0.3
    assert cli([str(d), "--require-epsilon"]) == 0
    empty = tmp_path / "empty"
    empty.mkdir()
    assert cli([str(empty), "--require-epsilon"]) == 1


# -- logging ---------------------------------------------------------------
def test_log_level_reread_on_reconfigure(monkeypatch):
    from repro_torch.utils.logging import get_logger, reconfigure

    monkeypatch.setenv("REPRO_LOG_LEVEL", "DEBUG")
    logger = get_logger("torch-obs-test-logger")
    assert logger.level == logging.DEBUG
    monkeypatch.setenv("REPRO_LOG_LEVEL", "WARNING")
    reconfigure()
    assert logger.level == logging.WARNING
    assert get_logger("torch-obs-test-logger").level == logging.WARNING


def test_rank_prefix_from_torch_distributed(monkeypatch):
    """Rank 0 and no prefix until a group of more than one rank exists; the
    rank then prefixes every record; no group is ever initialised here, and
    without ``torch.distributed`` imported nothing is."""
    import torch.distributed as dist

    from repro_torch.utils.logging import _rank_prefix, get_logger

    assert _rank_prefix() == "" and obs_events._rank() == 0
    assert not dist.is_initialized()
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 1)
    assert _rank_prefix() == "p1 " and obs_events._rank() == 1
    logger = get_logger("torch-obs-rank-test")
    record = logging.LogRecord("torch-obs-rank-test", logging.INFO, __file__, 1, "msg", (),
                               None)
    for f in logger.handlers[0].filters:
        f.filter(record)
    assert record.rank == "p1 "
    monkeypatch.delitem(sys.modules, "torch.distributed")
    assert _rank_prefix() == "" and obs_events._rank() == 0


# -- epsilon budget alarm ---------------------------------------------------
def test_epsilon_alarm_fires_once_like_jax():
    """Both packages' engines on one configuration: the 50% alarm fires at
    the same step, once, with the same record; disabled without a target or
    with fraction 0."""
    from repro_torch.core.engine import PrivacyEngine

    fired, records = [], []
    for engine_cls, pkg_sinks, kw in ((PrivacyEngine, tsinks,
                                       {"device": "cpu"}), (JPrivacyEngine, jsinks, {})):
        ev = MemorySink()
        pkg_sinks.set_sink("events", ev)
        engine = engine_cls(loss_with_ctx=lambda p, b, c: None, batch_size=10,
                            sample_size=100, max_grad_norm=1.0, steps=20,
                            target_epsilon=2.0, **kw)
        assert not engine.check_epsilon_alarm(0.5, step=0)
        hits = []
        for i in range(engine.steps):
            engine.record_step()
            hits.append(engine.check_epsilon_alarm(0.5, step=i + 1))
        fired.append(hits)
        (rec,) = [r for r in ev.records if r["kind"] == "epsilon_budget_crossed"]
        records.append({k: v for k, v in rec.items() if k not in ("t", "seq", "run_id")})
        off = engine_cls(loss_with_ctx=lambda p, b, c: None, batch_size=10, sample_size=100,
                         max_grad_norm=1.0, steps=5, noise_multiplier=0.4, **kw)
        off.record_step(5)
        assert not off.check_epsilon_alarm(0.5)
        off.target_epsilon = 0.01
        assert not off.check_epsilon_alarm(0.0)
        assert len(ev.records) == 1
    assert fired[0] == fired[1] and sum(fired[0]) == 1
    assert fired[0].index(True) < 19
    assert records[0] == records[1]
    assert records[0]["step"] == fired[0].index(True) + 1
