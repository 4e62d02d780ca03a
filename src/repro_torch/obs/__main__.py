"""CLI: render a run directory's obs streams into a human summary (port of
``obs/__main__.py``).

    python -m repro_torch.obs RUN_DIR [--json] [--require-epsilon]
                              [--timeline] [--step-pattern REGEX]

``RUN_DIR`` is the directory ``launch.train``/``launch.serve`` wrote
``events.jsonl``/``metrics.jsonl`` into (the ``--ckpt-dir``/``--obs-dir``).
``--json`` emits the machine summary instead of text; ``--require-epsilon``
exits non-zero when no epsilon trajectory was recorded (the tier-1 smoke
gate's assertion); ``--timeline`` additionally extracts per-step wall
times from a captured profiler trace under ``RUN_DIR/profile``: the host's
step spans and, for a trace taken on the card, each step's GPU span and the
CUDA kernel time inside it.

It never imports torch: reading a run's telemetry must work on a machine
that cannot initialise the run's device.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

from repro_torch.obs.report import render_text, summarize_run
from repro_torch.obs.timeline import (
    DEFAULT_STEP_PATTERN,
    percentile,
    step_kernel_ms,
    step_wall_times_ms,
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.obs")
    ap.add_argument("run_dir", help="directory holding events.jsonl/metrics.jsonl")
    ap.add_argument("--json", action="store_true",
                    help="print the machine-readable summary")
    ap.add_argument("--require-epsilon", action="store_true",
                    help="exit 1 unless a non-empty epsilon trajectory was "
                         "recorded (CI smoke assertion)")
    ap.add_argument("--timeline", action="store_true",
                    help="extract per-step wall times from the profiler "
                         "trace under RUN_DIR/profile")
    ap.add_argument("--step-pattern", default=DEFAULT_STEP_PATTERN,
                    help="regex over trace event names that count as "
                         "step/execution spans")
    args = ap.parse_args(argv)

    summary = summarize_run(args.run_dir)
    if args.timeline:
        prof = pathlib.Path(args.run_dir) / "profile"
        times = step_wall_times_ms(prof, pattern=args.step_pattern)
        summary["profile_step_times_ms"] = times
        summary["profile_step_p50_ms"] = (
            percentile(times, 0.50) if times else None
        )
        summary["profile_device_steps"] = step_kernel_ms(prof, pattern=args.step_pattern)

    if args.json:
        print(json.dumps(summary, sort_keys=True))
    else:
        print(render_text(summary))
        if args.timeline:
            times = summary["profile_step_times_ms"]
            if times:
                print(
                    f"  profiled steps: {len(times)} span group(s), "
                    f"p50 {percentile(times, 0.5):.1f}ms "
                    f"p95 {percentile(times, 0.95):.1f}ms"
                )
            else:
                print("  profiled steps: no trace found")
            for s in summary["profile_device_steps"]:
                print(f"  {s['name']} on the device: {s['span_ms']:.1f}ms span, "
                      f"{s['kernels']} kernels busy {s['kernel_ms']:.1f}ms")

    if args.require_epsilon and not summary["epsilon_trajectory"]:
        print("ERROR: no epsilon trajectory in the metrics stream",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
