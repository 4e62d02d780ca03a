#!/usr/bin/env python3
"""Tabulate a dry run's cells (``python -m repro_torch.launch.dryrun``'s
JSON files) as markdown: one row an arch, one column a (shape, mesh); each
cell the predicted peak GiB a rank, the NVLink wire GB a rank a step and
the roofline's bottleneck (m memory, c compute, n collective), "—" for a
skipped cell and "err" for an error.

    python3 scripts/dryrun_table.py [results/dryrun]
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
MESHES = ("single", "multi")
ABBREV = {"memory": "m", "compute": "c", "collective": "n"}


def cell(path: Path) -> str:
    if not path.exists():
        return "?"
    meta = json.loads(path.read_text())
    if meta["status"] == "skipped":
        return "—"
    if meta["status"] != "ok":
        return "err"
    roof = meta["roofline"]
    peak = roof["memory_stats"]["peak_bytes_estimate"] / 2**30
    return f"{peak:.1f} / {roof['wire_bytes_per_device'] / 1e9:.3g} / {ABBREV[roof['bottleneck']]}"


def main() -> int:
    root = Path(sys.argv[1] if len(sys.argv) > 1 else "results/dryrun")
    archs = sorted({p.name.split("__")[0] for m in MESHES for p in (root / m).glob("*.json")})
    cols = [(s, m) for s in SHAPES for m in MESHES]
    print("| arch | " + " | ".join(f"{s} {'16x16' if m == 'single' else '2x16x16'}"
                                   for s, m in cols) + " |")
    print("|---" * (len(cols) + 1) + "|")
    for arch in archs:
        print(f"| {arch} | " + " | ".join(cell(root / m / f"{arch}__{s}.json") for s, m in cols)
              + " |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
