"""Tuner CLI: profile a model's taps and write the ClipPlan artifact (port of
``tuner/cli.py``).

    PYTHONPATH=src python -m repro_torch.tuner --arch yi-6b --reduced --device cpu

Steps: build the arch from the registry (random weights from seed 0),
discover its taps on a synthetic batch (``data.synthetic.synthetic_arch_batch``),
time the three-way branch decision per matmul tap on the device
(``tuner.measure``), certify the largest physical microbatch under the
memory budget by trial (``tuner.max_batch``), re-measure at that batch, and
write the plan JSON (the cache path or ``--plan``).  The printed table
shows where the measured winner disagrees with the analytic Eq-(4.1) rule
and which mode (mixed_ghost or bk_mixed) the measurements recommend.

- ``--device``: where to run (default: the GPU; ``cpu`` runs the plain
  versions);
- ``--export-plan out.json``: also write the adopted plan elsewhere;
- ``--import-plan in.json``: skip measuring; load the plan and verify it
  strictly against this model and device (``tuner.plan.verify_plan``),
  exiting 1 on any mismatch;
- ``--consensus``: the fleet agreement, which comes with the runtime
  slice's ``tuner/consensus.py``; refused until then.
"""
from __future__ import annotations

import argparse
import json
import logging
import sys

import torch

from repro_torch.configs.registry import build_model, get_arch
from repro_torch.core.clipping import ClipConfig, discover_meta, dp_value_and_clipped_grad
from repro_torch.core.decision import decide
from repro_torch.core.engine import CONSENSUS_LATER
from repro_torch.data.synthetic import synthetic_arch_batch
from repro_torch.device import resolve_device
from repro_torch.tuner import max_batch as mb
from repro_torch.tuner.measure import MeasureConfig, build_plan, close_physical_batch_loop
from repro_torch.tuner.plan import ClipPlan, default_plan_path, verify_plan

log = logging.getLogger("repro_torch.tuner")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="repro_torch.tuner")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs the plain versions)")
    ap.add_argument("--batch", type=int, default=4,
                    help="physical microbatch used for profiling")
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--logical-batch", type=int, default=None,
                    help="derive accumulation_steps for this logical batch "
                         "(default: --batch)")
    ap.add_argument("--plan", default=None,
                    help="output path (default: the tuner's cache directory)")
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--max-rows", type=int, default=64,
                    help="clamp profiled rows N (0 = unclamped, use --batch as-is)")
    ap.add_argument("--budget-gb", type=float, default=16.0,
                    help="memory budget for the max-batch search")
    ap.add_argument("--hi-cap", type=int, default=4096)
    ap.add_argument("--skip-max-batch", action="store_true")
    ap.add_argument("--skip-remeasure", action="store_true",
                    help="do not re-time branches at the tuned physical batch")
    ap.add_argument("--mode", default="mixed_ghost",
                    help="clipping mode the max-batch search runs")
    ap.add_argument("--consensus", action="store_true",
                    help="fleet agreement after measuring (not ported yet)")
    ap.add_argument("--export-plan", default=None,
                    help="also write the adopted plan here (offline fleets)")
    ap.add_argument("--import-plan", default=None,
                    help="skip measuring: load + strictly verify this plan against "
                         "the local model and device (exit 1 on a mismatch)")
    return ap.parse_args(argv)


def _import(args, cfg, metas, device) -> int:
    """Adopt a plan measured elsewhere, or exit 1."""
    try:
        plan = ClipPlan.load(args.import_plan)
        verify_plan(plan, metas, device)
    except (ValueError, KeyError, OSError, json.JSONDecodeError) as e:
        log.error("cannot adopt %s: %s", args.import_plan, e)
        print(f"cannot adopt {args.import_plan}: {e}", file=sys.stderr)
        return 1
    for out in {args.plan, args.export_plan} - {None}:
        plan.save(out)  # re-export the canonical artifact
    print(f"adopted ClipPlan {args.import_plan} for {cfg.name} on {plan.device} "
          f"(hash {plan.consensus_hash()})")
    print(f"recommended mode: {plan.recommended_mode()}  "
          f"max physical batch: {plan.physical_batch}")
    return 0


def _search_fn(model, params, batch, args, budget):
    def search(plan) -> int:
        grad_fn = dp_value_and_clipped_grad(model.loss_with_ctx,
                                            ClipConfig(mode=args.mode, plan=plan))
        mp, method = mb.certify_max_batch(
            grad_fn, params, batch, budget_bytes=budget, hi_cap=args.hi_cap,
            reserved_bytes=mb.resident_state_bytes(params))
        log.info("max physical batch certified by %s: %d", method, mp)
        return mp

    return search


def _print_table(cfg, plan: ClipPlan, metas, path: str) -> None:
    branch_map = plan.branch_map()
    bk_map = plan.branch_map("bk_mixed")
    timing = plan.tap_timings()
    print(f"\nClipPlan for {cfg.name} on {plan.device}  ->  {path}")
    print(f"{'tap':<40s} {'T':>5s} {'D':>6s} {'p':>6s} "
          f"{'ghost_us':>9s} {'inst_us':>9s} {'bk_g_us':>9s} {'bk_i_us':>9s} "
          f"{'2bwd_us':>8s} {'analytic':>11s} {'measured':>11s} {'bk':>11s}")
    flips = 0
    for name in sorted(branch_map):
        m = metas[name]
        analytic = decide(m, mode="mixed_ghost")
        measured = branch_map[name]
        t = timing[name]
        flag = "  <- flip" if analytic != measured else ""
        flips += analytic != measured
        print(f"{name:<40s} {m.T:>5d} {m.D:>6d} {m.p:>6d} "
              f"{t.ghost_us:>9.1f} {t.instantiate_us:>9.1f} "
              f"{t.bk_ghost_us:>9.1f} {t.bk_instantiate_us:>9.1f} "
              f"{t.second_bwd_us:>8.1f} {analytic:>11s} {measured:>11s} "
              f"{bk_map.get(name, '-'):>11s}{flag}")
    print(f"\n{flips}/{len(branch_map)} taps flip vs the analytic rule")
    impls = sorted({impl for ops in plan.kernel_map().values() for impl in ops.values()})
    if impls:
        # one production impl per device: the kernels on the card, the
        # plain versions on the CPU (recorded, not raced)
        print(f"kernel impls: {', '.join(impls)} everywhere (one production impl "
              "on this device, nothing raced)")
    print(f"measured per-step clipping cost: mixed_ghost="
          f"{plan.mode_cost_us('mixed_ghost'):.1f}us  "
          f"bk_mixed={plan.mode_cost_us('bk_mixed'):.1f}us  "
          f"-> recommended mode: {plan.recommended_mode()}")
    if plan.physical_batch:
        at = " (branches re-measured there)" if plan.measured_at_physical else ""
        print(f"max physical batch: {plan.physical_batch} "
              f"(logical {plan.logical_batch} = {plan.accumulation_steps} microsteps){at}")


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.consensus:
        raise NotImplementedError(CONSENSUS_LATER)
    device = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg, device=device)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    batch = synthetic_arch_batch(cfg, batch=args.batch, seq=args.seq, device=device)

    metas = discover_meta(model.loss_with_ctx, params, batch)
    log.info("discovered %d taps (%d matmul) on %s", len(metas),
             sum(1 for m in metas.values() if m.kind == "matmul"), device)
    if args.import_plan:
        return _import(args, cfg, metas, device)

    measure = MeasureConfig(repeats=args.repeats, warmup=args.warmup,
                            max_rows=args.max_rows or None)
    plan = build_plan(metas, measure=measure, arch=cfg.name, device=device)
    if not args.skip_max_batch:
        budget = int(args.budget_gb * 1024**3)
        search = _search_fn(model, params, batch, args, budget)
        max_physical = search(plan)
        if max_physical <= 0:
            log.warning("no batch fits the %.1f GB budget; the plan has no physical_batch",
                        args.budget_gb)
        else:
            logical = args.logical_batch or args.batch
            physical, steps = mb.derive_accumulation(logical, max_physical)
            plan = plan.replace_batch(physical_batch=max_physical, logical_batch=logical,
                                      accumulation_steps=steps, budget_bytes=budget)
            log.info("max physical batch %d under %.1f GB; logical %d -> %d x %d microsteps",
                     max_physical, args.budget_gb, logical, physical, steps)
            if not args.skip_remeasure:
                # the step runs at the certified batch: measure the decision
                # there, re-certifying the batch if a branch flips
                plan = close_physical_batch_loop(plan, metas, search, logical, budget,
                                                 measure, device=device)

    path = args.plan or default_plan_path(cfg.name, plan.fingerprint)
    plan.save(path)
    if args.export_plan:
        plan.save(args.export_plan)
    _print_table(cfg, plan, metas, path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
