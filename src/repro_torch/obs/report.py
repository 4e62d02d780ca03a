"""Fold a run directory's record streams into one human/machine summary (a
copy of ``obs/report.py``).

``summarize_run`` is the pure half (dict in, dict out — tests and the
bench dashboard consume it); ``render_text`` is the presentation half the
``python -m repro_torch.obs`` CLI prints.  Everything reads through
``sinks.read_jsonl``, so a crash-torn final line costs one record, not the
report.
"""
from __future__ import annotations

import pathlib
from collections import Counter
from typing import Optional

from repro_torch.obs.events import EVENTS_FILENAME, METRICS_FILENAME
from repro_torch.obs.sinks import read_jsonl
from repro_torch.obs.timeline import percentile


def summarize_run(run_dir) -> dict:
    """Digest ``events.jsonl``/``metrics.jsonl`` under ``run_dir``."""
    run_dir = pathlib.Path(run_dir)
    events = read_jsonl(run_dir / EVENTS_FILENAME)
    metrics = read_jsonl(run_dir / METRICS_FILENAME)
    train = [m for m in metrics if m.get("kind") == "train_step"]
    serving = [m for m in metrics if m.get("kind") == "serving_step"]

    eps_traj = [
        (int(m["step"]), float(m["epsilon"]))
        for m in train
        if m.get("epsilon") is not None and m.get("step") is not None
    ]
    step_times = [float(m["step_s"]) for m in train if m.get("step_s")]
    clip_fracs = [
        float(m["clip_frac"]) for m in train if m.get("clip_frac") is not None
    ]
    ex_rates = [
        float(m["examples_per_s"]) for m in train if m.get("examples_per_s")
    ]
    event_counts = Counter(str(e.get("kind", "?")) for e in events)

    # the newest plan_adopted event carries the per-tap branch + kernel maps
    plan_ev: Optional[dict] = None
    for e in events:
        if e.get("kind") == "plan_adopted":
            plan_ev = e

    run_ids = {m.get("run_id") for m in (train + events) if m.get("run_id")}
    return {
        "run_dir": str(run_dir),
        "run_ids": sorted(run_ids),
        "train_steps": len(train),
        "epsilon_trajectory": eps_traj,
        "final_epsilon": eps_traj[-1][1] if eps_traj else None,
        "final_delta": (
            float(train[-1]["delta"])
            if train and train[-1].get("delta") is not None else None
        ),
        "clip_frac_mean": (
            sum(clip_fracs) / len(clip_fracs) if clip_fracs else None
        ),
        "step_time_p50_s": percentile(step_times, 0.50) if step_times else None,
        "step_time_p95_s": percentile(step_times, 0.95) if step_times else None,
        "examples_per_s_mean": (
            sum(ex_rates) / len(ex_rates) if ex_rates else None
        ),
        "events": dict(sorted(event_counts.items())),
        "restarts": event_counts.get("restart_attempt", 0),
        "sheds": event_counts.get("request_shed", 0),
        "watchdog_trips": event_counts.get("watchdog_trip", 0),
        "plan": plan_ev,
        "serving_steps": len(serving),
        "last_serving": serving[-1] if serving else None,
    }


def _sparkline(values: list[float], width: int = 32) -> str:
    """Compact ASCII trend (monotone epsilon curves read fine at 8 levels)."""
    if not values:
        return ""
    if len(values) > width:  # subsample evenly to the display width
        idx = [round(i * (len(values) - 1) / (width - 1)) for i in range(width)]
        values = [values[i] for i in idx]
    lo, hi = min(values), max(values)
    chars = ".:-=+*#%"
    if hi <= lo:
        return chars[0] * len(values)
    return "".join(
        chars[min(len(chars) - 1, int((v - lo) / (hi - lo) * len(chars)))]
        for v in values
    )


def render_text(summary: dict) -> str:
    lines = [f"run {summary['run_dir']}"]
    if summary["run_ids"]:
        lines.append(f"  run_id(s): {', '.join(summary['run_ids'])}")
    lines.append(f"  train steps recorded: {summary['train_steps']}")

    traj = summary["epsilon_trajectory"]
    if traj:
        eps = [e for _, e in traj]
        lines.append(
            f"  epsilon: {eps[0]:.4f} -> {eps[-1]:.4f} over steps "
            f"{traj[0][0]}..{traj[-1][0]}  [{_sparkline(eps)}]"
        )
        if summary["final_delta"] is not None:
            lines.append(f"  delta: {summary['final_delta']:.2e}")
    else:
        lines.append("  epsilon: no trajectory recorded")
    if summary["clip_frac_mean"] is not None:
        lines.append(f"  clip fraction (mean): {summary['clip_frac_mean']:.3f}")
    if summary["step_time_p50_s"] is not None:
        lines.append(
            f"  step time: p50 {summary['step_time_p50_s'] * 1e3:.1f}ms "
            f"p95 {summary['step_time_p95_s'] * 1e3:.1f}ms"
        )
    if summary["examples_per_s_mean"] is not None:
        lines.append(
            f"  throughput: {summary['examples_per_s_mean']:.1f} examples/s"
        )

    plan = summary["plan"]
    if plan is not None:
        src = plan.get("source", "plan")
        lines.append(
            f"  clipping: mode={plan.get('mode')} policy={plan.get('policy')} "
            f"({src}; physical={plan.get('physical_batch')} "
            f"accum={plan.get('accumulation_steps')})"
        )
        branches = plan.get("branches") or {}
        kernels = plan.get("kernels") or {}
        for tap in sorted(set(branches) | set(kernels)):
            b = branches.get(tap, "-")
            k = kernels.get(tap)
            ktxt = (
                " ".join(f"{op}={impl}" for op, impl in sorted(k.items()))
                if k else "-"
            )
            lines.append(f"    tap {tap}: branch={b} kernels[{ktxt}]")

    ev = summary["events"]
    if ev:
        lines.append(
            "  events: " + ", ".join(f"{k}={v}" for k, v in ev.items())
        )
    if summary["serving_steps"]:
        last = summary["last_serving"] or {}
        lines.append(
            f"  serving: {summary['serving_steps']} step records, "
            f"queue_depth={last.get('queue_depth')} "
            f"shed_total={last.get('shed_total')}"
        )
    return "\n".join(lines)
