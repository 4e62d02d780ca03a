#!/usr/bin/env python3
"""Run chip_smoke.py's dryrun phase alone on one GPU, with what it reads:
build the kernels, run the slice phase of VGG-19, Yi-6B and Mixtral-8x7B
(one timed step each), then the dryrun phase (its predictions against
those live steps), then the dist phase's tp part on two gloo ranks sharing
the card and the phase's tp gate against it.

    python3 scripts/dryrun_phase.py

Prints the card's name and power limit first and last; exits non-zero
when a gate fails.  Writes the card and the predictions to
chiprun_out/dryrun_phase.json.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src"), str(ROOT / "scripts")]
import axis_parts  # noqa: E402
import chip_smoke as cs  # noqa: E402


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("dryrun_phase: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.phase_card()
    cs.phase_build()
    paths = cs._paths()
    slices = {}
    for tag in dict.fromkeys(tag for tag, _ in cs.DRYRUN_CELLS):
        cs._settle()
        t0 = time.perf_counter()
        slices[tag] = cs.phase_slice(tag, paths[tag], 1)
        cs._free()
        print(f"slice {tag}: {time.perf_counter() - t0:.1f} s", flush=True)
    del paths
    cs._settle()
    t0 = time.perf_counter()
    pred = cs.phase_dryrun(slices)
    cs._free()
    print(f"phase dryrun: {time.perf_counter() - t0:.1f} s", flush=True)
    cs._settle()
    t0 = time.perf_counter()
    results = cs.spawn_ranks(axis_parts._parts, ["tp"])
    rep = cs._axis_report(results, "tp")
    print(f"tp part: {time.perf_counter() - t0:.1f} s", flush=True)
    cs.dryrun_tp_gate(pred, {"tp": rep})
    cs.OUT_DIR.mkdir(exist_ok=True)
    (cs.OUT_DIR / "dryrun_phase.json").write_text(
        json.dumps({"card": card, **pred}, indent=1, default=str))
    print(card["nvidia_smi"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
