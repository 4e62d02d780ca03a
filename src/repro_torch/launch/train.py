"""DP training driver (port of ``launch/train.py``).

Full loop on one process: data pipeline -> mixed-ghost (or book-keeping)
clipped grads, with gradient accumulation -> Gaussian noise -> optimizer ->
checkpoint manager -> privacy accountant, with the straggler watchdog,
preemption-to-checkpoint, and an ``--auto-restart`` supervision loop that
resumes from the latest checkpoint after a crash (fault injection through
``--inject`` / ``$REPRO_FAULT_INJECT`` or ``--fail-at-step``).  The flags
and the ``summary.json`` fields are the JAX CLI's.

    python -m repro_torch.launch.train --arch yi-6b --reduced --device cpu \\
        --steps 6 --batch 2 --seq 16 --ckpt-dir /tmp/ckpt --inject crash@4 --auto-restart 2

It runs on the GPU unless ``--device cpu`` is given, and raises without a
GPU.  ``--tune`` / ``--plan`` / ``--mode auto`` adopt a measured ClipPlan
(``repro_torch.tuner``) and switch to gradient accumulation when the
certified physical batch is below ``--batch``; ``--obs-dir`` (default: the
checkpoint directory) receives the event and metrics streams and, with
``--profile-steps N:M``, a ``torch.profiler`` trace of steps N..M.

Where the JAX CLI shards the state and the batch over a host mesh
(``make_host_mesh``, ``state_shardings``, ``per_host_batch``), this one runs
on one process: the per-host batch is the batch, and ``--data-shards`` /
``$REPRO_ELASTIC_SHARDS`` turns shards into accumulation microsteps of the
same per-shard microbatch, as on one JAX host.  ``--consensus`` raises: the
fleet agreement comes with ``parallel/``.

Each logical step ends in one host sync, the copy of its metrics to the
host: it bounds the queue of enqueued work, makes the watchdog time executed
steps, and the log line and the metrics stream read its values, so the obs
streams add no sync of their own.  A resumed run is bit-identical to an
uninterrupted one, on the CPU and on the card: the checkpoint carries the
noise generator's state, the Poisson masks come from a generator seeded per
step (the JAX CLI's ``fold_in(PRNGKey(4242), step)``), and every op on the
path is deterministic (the embedding's weighted gradient accumulates in a
sorted order, ``core.ghost``).  ``run_once`` and ``main`` take an optional
``arch`` (an ``ArchConfig``, e.g. a depth cut of a registry arch) in place of
``--arch``'s registry entry; with it, ``--seq`` holds at full width too.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import sys
import time
from typing import Optional

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import ArchConfig, torch_dtype
from repro_torch.configs.registry import build_model, get_arch
from repro_torch.core.engine import CONSENSUS_LATER, PrivacyEngine
from repro_torch.data.pipeline import DataPipeline
from repro_torch.data.poisson import poisson_sample_mask
from repro_torch.data.synthetic import synthetic_arch_batch
from repro_torch.device import resolve_device
from repro_torch.launch.steps import (
    DPTrainConfig,
    make_accum_finalize,
    make_accum_init,
    make_accum_microstep,
    make_train_state,
    make_train_step,
)
from repro_torch.obs import events as obs
from repro_torch.obs.profile import ProfileWindow
from repro_torch.optim import adam, warmup_cosine
from repro_torch.runtime.elastic import current_data_shards, elastic_plan
from repro_torch.runtime.fault import PreemptionHandler, StepWatchdog
from repro_torch.runtime.inject import InjectionPlan
from repro_torch.utils.logging import get_logger, reconfigure

log = get_logger("train")

POISSON_SEED = 4242
# the step's metrics that cross to the host in its one sync
HOST_METRICS = ("loss", "clip_frac", "norm_mean", "norm_max")


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current GPU; 'cpu' must be asked for)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--mode", default="mixed_ghost",
                    help="clipping mode (see core.clipping.MODES), or 'auto' "
                         "to adopt the tuned plan's recommended_mode")
    ap.add_argument("--clip-norm", type=float, default=1.0)
    ap.add_argument("--clip-policy", default="fixed",
                    choices=["fixed", "automatic", "quantile", "per_layer"],
                    help="clipping policy (repro_torch.policies): fixed flat R, "
                         "automatic AUTO-S normalization (no R), quantile "
                         "DP-adaptive R, or per_layer group thresholds")
    ap.add_argument("--clip-quantile", type=float, default=0.5,
                    help="quantile policy: target norm quantile for R")
    ap.add_argument("--quantile-lr", type=float, default=0.2,
                    help="quantile policy: geometric update rate for R")
    ap.add_argument("--quantile-sigma", type=float, default=1.0,
                    help="quantile policy: noise multiplier of the "
                         "indicator release (composed into the accountant; "
                         "0 disables the release and its DP guarantee)")
    ap.add_argument("--auto-gamma", type=float, default=0.01,
                    help="automatic policy: stability constant (0 = AUTO-V)")
    ap.add_argument("--layer-groups", default="",
                    help="per_layer policy: comma-separated param-path "
                         "prefixes, one threshold per group (a catch-all "
                         "group is added automatically)")
    ap.add_argument("--target-epsilon", type=float, default=None)
    ap.add_argument("--epsilon-alarm-frac", type=float, default=0.9,
                    help="emit a one-shot epsilon_budget_crossed event when "
                         "the accountant passes this fraction of "
                         "--target-epsilon (<=0 disables)")
    ap.add_argument("--noise-multiplier", type=float, default=1.0)
    ap.add_argument("--sample-size", type=int, default=50000)
    ap.add_argument("--poisson", action="store_true",
                    help="Poisson subsampling masks (DP accounting assumption)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--auto-restart", type=int, default=0,
                    help="supervise and restart up to N times on failure")
    ap.add_argument("--fail-at-step", type=int, default=None,
                    help="fault injection: raise at this step (tests); "
                         "shorthand for --inject crash@STEP")
    ap.add_argument("--inject", default=None,
                    help="deterministic fault injection spec "
                         "(runtime.inject), e.g. 'crash@5,torn@4' or "
                         "'shrink@5:1'; merged with $REPRO_FAULT_INJECT")
    ap.add_argument("--data-shards", type=int, default=0,
                    help="data-parallel degree of the fleet (0 = "
                         "$REPRO_ELASTIC_SHARDS, else 1); the elastic "
                         "replan keeps the logical batch across resizes")
    ap.add_argument("--elastic-max-per-shard", type=int, default=0,
                    help="per-shard microbatch cap for the elastic replan "
                         "(0 = the tuned/physical microbatch)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--obs-dir", default=None,
                    help="directory for the observability streams "
                         "(events.jsonl/metrics.jsonl; default: --ckpt-dir). "
                         "Read back with `python -m repro_torch.obs DIR`")
    ap.add_argument("--profile-steps", default=None, metavar="N[:M]",
                    help="capture a torch.profiler trace around the inclusive "
                         "step window [N, M] into <obs-dir>/profile "
                         "(repro_torch.obs.timeline extracts per-step times)")
    ap.add_argument("--tune", action="store_true",
                    help="profile ghost-vs-instantiate per tap and search the "
                         "max physical microbatch before training")
    ap.add_argument("--consensus", action="store_true",
                    help="fleet-safe tuning/plan adoption (not in this port yet: raises)")
    ap.add_argument("--plan", default=None,
                    help="ClipPlan JSON to load (or, with --tune, to write)")
    ap.add_argument("--tune-budget-gb", type=float, default=16.0,
                    help="memory budget for the --tune max-batch search")
    ap.add_argument("--tune-hi-cap", type=int, default=4096)
    return ap.parse_args(argv)


def _injection_for(args) -> InjectionPlan:
    """One InjectionPlan per process: ``--inject`` + env, with the legacy
    ``--fail-at-step N`` folded in as a ``crash@N`` injector.  Injectors are
    one-shot, so in-process ``--auto-restart`` attempts share the plan and a
    fault that already fired does not re-fire after the restart."""
    plan = InjectionPlan.from_spec(args.inject)
    if args.fail_at_step is not None:
        plan.add_crash(args.fail_at_step)
    return plan


def _write_summary(ckpt_dir: str, **fields) -> None:
    """Machine-readable run outcome next to the checkpoints (tests compare
    the privacy spend of interrupted vs uninterrupted runs through this)."""
    path = pathlib.Path(ckpt_dir) / "summary.json"
    tmp = path.with_name(".tmp_summary.json")
    tmp.write_text(json.dumps(fields, sort_keys=True))
    tmp.replace(path)


def _process_count() -> int:
    dist = torch.distributed
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def poisson_generator(device: torch.device, step: int) -> torch.Generator:
    """The generator of step ``step``'s Poisson mask: seeded by the step
    alone, so a resumed run redraws the masks of the uninterrupted one."""
    return torch.Generator(device=device).manual_seed(POISSON_SEED * 1_000_003 + step)


def host_metrics(metrics: dict) -> dict:
    """The step's metrics on the host: ONE device-to-host copy, the loop's
    only sync per logical batch (obs and logging read its values)."""
    vals = torch.stack([metrics[k].detach().float().reshape(()) for k in HOST_METRICS])
    out = dict(zip(HOST_METRICS, vals.tolist()))
    out["lr"] = float(metrics["lr"])
    return out


def run_once(args, injection: Optional[InjectionPlan] = None, *,
             arch: Optional[ArchConfig] = None) -> int:
    if args.consensus:
        raise NotImplementedError(CONSENSUS_LATER)
    if injection is None:
        injection = _injection_for(args)
    device = resolve_device(args.device)
    # observability streams live next to the checkpoints unless redirected;
    # configure_run(None) resets any sinks a previous in-process run left
    # installed, and re-configuring the SAME dir keeps appending (so every
    # --auto-restart attempt lands in one events.jsonl timeline)
    run_dir = args.obs_dir or args.ckpt_dir
    obs.configure_run(run_dir)
    obs.emit_event(
        "run_started", arch=args.arch, reduced=bool(args.reduced),
        steps=args.steps, logical_batch=args.batch, seq_len=args.seq,
        mode=args.mode, policy=args.clip_policy, resume=bool(args.resume),
        ckpt_dir=args.ckpt_dir, device=str(device),
    )
    profile = None
    if args.profile_steps:
        if run_dir is None:
            log.warning("--profile-steps needs --obs-dir or --ckpt-dir for "
                        "the trace output; skipping profiling")
        else:
            profile = ProfileWindow.from_spec(args.profile_steps, run_dir, device)
    cfg = arch if arch is not None else get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg, device=device)

    # clipping policy (repro_torch.policies): make_policy filters the kwarg
    # union down to what the chosen policy's __init__ actually takes
    from repro_torch.policies import make_policy

    policy = make_policy(
        args.clip_policy,
        clip_norm=args.clip_norm,
        init_clip_norm=args.clip_norm,
        gamma=args.auto_gamma,
        target_quantile=args.clip_quantile,
        lr=args.quantile_lr,
        release_sigma=args.quantile_sigma,
        groups=tuple(g for g in args.layer_groups.split(",") if g),
    )
    if args.clip_policy != "fixed":
        log.info("clipping policy: %s", policy.fingerprint())

    # privacy engine: sigma from target epsilon (or given), accountant
    # attached.  With --target-epsilon the bisection composes the policy's
    # per-step release (quantile indicator) so the TOTAL spend hits the target
    def make_engine(batch_size: int, mode: str) -> PrivacyEngine:
        return PrivacyEngine(
            loss_with_ctx=model.loss_with_ctx,
            batch_size=batch_size,
            sample_size=args.sample_size,
            steps=args.steps,
            max_grad_norm=args.clip_norm,
            target_epsilon=args.target_epsilon,
            noise_multiplier=None if args.target_epsilon else args.noise_multiplier,
            mode=mode,
            clip_policy=policy,
            device=device,
        )

    # '--mode auto' is resolved from the tuned plan below; tune/search under
    # the paper default in the meantime
    clip_mode = "mixed_ghost" if args.mode == "auto" else args.mode
    engine = make_engine(args.batch, clip_mode)
    log.info("noise multiplier sigma=%.4f (q=%.5f)", engine.noise_multiplier,
             engine.sampling_rate)

    optimizer = adam(state_dtype=torch_dtype(cfg.opt_state_dtype))
    schedule = warmup_cosine(args.lr, max(args.steps // 20, 1), args.steps)

    state = make_train_state(model, 0, optimizer, policy)

    # measured-cost autotuning: load a cached ClipPlan or profile one now.
    # One process: the memory certificates run at the whole batch
    seq = args.seq if (args.reduced or arch is not None) else 4096
    probe_batch = args.batch
    plan = None
    if args.plan and not args.tune:
        from repro_torch.core.clipping import discover_meta
        from repro_torch.tuner import ClipPlan

        probe = synthetic_arch_batch(cfg, batch=probe_batch, seq=seq, device=device)
        metas = discover_meta(model.loss_with_ctx, state["params"], probe)
        try:
            plan = ClipPlan.load(args.plan)
        except (ValueError, KeyError) as e:
            # e.g. a pre-three-way (v1) artifact: unreadable == stale
            log.warning("unreadable ClipPlan %s (%s); falling back to the "
                        "analytic decision", args.plan, e)
            plan = None
        if plan is not None and not plan.matches(metas, device):
            # a stale plan must not drive anything — neither the branch
            # overrides nor the microbatch geometry it measured elsewhere
            log.warning("ClipPlan %s is stale for this arch/device; "
                        "falling back to the analytic decision", args.plan)
            plan = None
        if plan is not None:
            engine.use_plan(plan)
            log.info("loaded ClipPlan %s (device %s, %d branch overrides)",
                     args.plan, plan.device, len(plan.branches))
    elif args.tune:
        probe = synthetic_arch_batch(cfg, batch=probe_batch, seq=seq, device=device)
        plan = engine.tune(
            state["params"], probe, arch=cfg.name,
            budget_bytes=int(args.tune_budget_gb * 1024**3),
            hi_cap=args.tune_hi_cap,
            plan_path=args.plan if args.plan else "auto",
        )
        log.info("tuned %d taps; max physical batch=%s", len(plan.branches),
                 plan.physical_batch)

    if args.mode == "auto":
        if plan is not None:
            clip_mode = plan.recommended_mode()
            log.info("--mode auto: measured recommendation is %s "
                     "(mixed_ghost=%.1fus bk_mixed=%.1fus per step)",
                     clip_mode, plan.mode_cost_us("mixed_ghost"),
                     plan.mode_cost_us("bk_mixed"))
        else:
            log.warning("--mode auto without a usable plan; staying on %s "
                        "(pass --tune or a valid --plan)", clip_mode)
        if clip_mode != engine.mode:
            # the max-batch certificate was searched under the tuning mode;
            # book-keeping banks residuals the searched step never
            # allocated, so re-certify under the adopted mode before
            # committing to it
            candidate = make_engine(args.batch, clip_mode)
            if plan is not None:
                candidate.use_plan(plan)
                if plan.physical_batch and plan.budget_bytes:
                    replan = candidate.recertify_max_batch(
                        state["params"], probe, hi_cap=args.tune_hi_cap
                    )
                    if replan is None:
                        log.warning(
                            "no batch fits the budget under %s; staying on "
                            "the certified tuning mode %s", clip_mode,
                            engine.mode,
                        )
                        clip_mode = engine.mode
                        candidate = None
                    else:
                        plan = replan
            if candidate is not None:
                engine = candidate

    physical, accum = args.batch, 1
    if plan is not None and plan.physical_batch:
        from repro_torch.tuner import derive_accumulation

        physical, accum = derive_accumulation(args.batch, plan.physical_batch)
    logical_eff = physical * accum
    if accum > 1:
        log.info(
            "tuned physical batch=%d (max %d): logical %d -> %d accumulation "
            "steps (effective logical %d)", physical, plan.physical_batch,
            args.batch, accum, logical_eff,
        )
    if logical_eff != args.batch:
        # accumulation rounding changed the per-step sample count: rebuild
        # the engine so the accountant's sampling rate (and sigma, when
        # derived from a target epsilon) match what actually runs
        log.info("effective logical batch %d != requested %d; re-deriving "
                 "privacy accounting", logical_eff, args.batch)
        engine = make_engine(logical_eff, clip_mode)
        if plan is not None:
            engine.use_plan(plan)

    # elastic fleet layout (runtime.elastic): recomputed on EVERY start —
    # including every --auto-restart attempt — from the shard count the
    # fleet actually has now ($REPRO_ELASTIC_SHARDS is the restart-time
    # seam; a scheduler or a shrink@step injector updates it between
    # attempts).  The logical batch (and with it the sampling rate q the
    # accountant composes) never changes; lost parallelism becomes extra
    # accumulation microsteps of the SAME per-shard microbatch, so a resumed
    # run replays the identical microbatch stream bit for bit.
    data_shards = current_data_shards(args.data_shards)
    if data_shards > 1 or args.elastic_max_per_shard:
        eplan = elastic_plan(
            logical_batch=logical_eff,
            data_shards=data_shards,
            max_per_shard=args.elastic_max_per_shard or physical,
        )
        physical, accum = eplan.execution(_process_count())
        log.info(
            "elastic layout: %d shard(s) x per-shard %d (accum %d) -> "
            "microbatch %d, %d microstep(s) per logical batch of %d",
            eplan.data_shards, eplan.per_shard_batch,
            eplan.accumulation_steps, physical, accum, logical_eff,
        )

    # the adopted configuration, as actually run: per-tap branch map +
    # kernel winners from the plan (or the analytic rule), plus the executed
    # batch layout (which the elastic replan may have reshaped past the
    # plan's own certificate)
    plan_fields = engine.plan_event_fields()
    plan_fields.update(
        mode=clip_mode, physical_batch=physical, accumulation_steps=accum,
        logical_batch=logical_eff, data_shards=data_shards,
    )
    obs.emit_event("plan_adopted", **plan_fields)

    dp = DPTrainConfig(
        clipping_mode=clip_mode,
        clip_norm=args.clip_norm,
        noise_multiplier=engine.noise_multiplier,
        logical_batch=logical_eff,
        accumulation_steps=accum,
        plan=plan,
        policy=policy,
    )

    # data (microbatches of the tuned physical size)
    def batch_fn(step, shard):
        b = synthetic_arch_batch(cfg, batch=physical, seq=seq, step=step, shard=shard,
                                 device=device)
        if args.poisson:
            b["mask"] = poisson_sample_mask(poisson_generator(device, step), physical,
                                            engine.sampling_rate)
        return b

    start_step = 0
    manager = None
    if args.ckpt_dir:
        manager = CheckpointManager(
            args.ckpt_dir, save_every=args.ckpt_every,
            on_saved=injection.on_checkpoint_saved if injection else None,
        )
        if args.resume and manager.latest() is not None:
            # every leaf back as the fresh state holds it (device, dtype,
            # generator); a pre-policy checkpoint keeps the fresh policy state
            start_step, state = manager.restore(cast_to=state, fill=("policy",))
            log.info("resumed from step %d", start_step)
            engine.record_step(start_step)

    pipeline = DataPipeline(batch_fn, start_step=start_step * accum).start()
    if accum == 1:
        step_fn = make_train_step(model, optimizer, schedule, dp, device=device)
    else:
        # virtual-step pattern: accumulate clipped grad sums over physical
        # microbatches in place, then noise + update once per logical step;
        # the policy update runs once per LOGICAL batch, over the per-sample
        # norms (and Poisson mask) of every microstep
        init_fn = make_accum_init(state["params"], physical * accum)
        micro_fn = make_accum_microstep(model, dp)
        fin_fn = make_accum_finalize(optimizer, schedule, dp)

    watchdog = StepWatchdog()
    preempt = PreemptionHandler().install()

    step = start_step
    rng_at_step, in_step = None, False
    try:
        while step < args.steps:
            if accum == 1:
                step_idx, batch = pipeline.next()
                watchdog.start_step()
            else:
                watchdog.start_step()
                step_idx = step
            injection.on_step(step_idx)
            if profile is not None:
                profile.before_step(step_idx)
            # a failure inside the step may have drawn noise from the
            # generator in place: the exit checkpoint rewinds it
            rng_at_step, in_step = state["rng"].get_state(), True
            with profile.span(step_idx) if profile is not None else contextlib.nullcontext():
                if accum == 1:
                    state, metrics = step_fn(state, batch)
                else:
                    # every microstep only enqueues work into the
                    # accumulator; nothing on the host reads a device value
                    acc = init_fn()
                    for i in range(accum):
                        _, batch = pipeline.next()
                        acc = micro_fn(state["params"], state["policy"], acc, batch, i)
                    state, metrics = fin_fn(state, acc)
                m = host_metrics(metrics)
            in_step = False
            engine.record_step()
            engine.check_epsilon_alarm(args.epsilon_alarm_frac, step=step_idx + 1)
            dt = watchdog.end_step(step_idx)
            step = step_idx + 1
            if profile is not None:
                profile.after_step(step_idx)
            if obs.metrics_active():
                eps_m, delta_m = engine.privacy_spent()
                obs.emit_metrics(
                    {
                        "kind": "train_step",
                        **m,
                        "epsilon": eps_m,
                        "delta": delta_m,
                        "step_s": dt,
                        "examples_per_s": logical_eff / dt if dt > 0 else None,
                        "physical_batch": physical,
                        "accumulation_steps": accum,
                        "mode": clip_mode,
                    },
                    step=step,
                )
            if step % args.log_every == 0 or step == args.steps:
                eps, _ = engine.privacy_spent()
                log.info(
                    "step %d loss=%.4f lr=%.2e clip_frac=%.2f eps=%.3f (%.2fs/step)",
                    step, m["loss"], m["lr"], m["clip_frac"], eps, dt,
                )
            if manager is not None:
                if preempt.preempted():
                    manager.save(step, state, force=True)
                    manager.wait()
                    log.warning("preempted: checkpointed step %d, exiting", step)
                    obs.emit_event("preemption", step=step, checkpointed=True)
                    return 0
                manager.save(step, state)
    finally:
        pipeline.stop()
        preempt.uninstall()
        if profile is not None:
            profile.stop(step=step)
        if manager is not None:
            if in_step:
                state["rng"].set_state(rng_at_step)
            manager.save(step, state, force=True)
            manager.wait()
    eps, delta = engine.privacy_spent()
    log.info("done: %d steps, privacy spent (eps=%.3f, delta=%.1e)", step, eps, delta)
    obs.emit_event("run_finished", step=step, epsilon=eps, delta=delta)
    if args.ckpt_dir:
        _write_summary(
            args.ckpt_dir, step=step, epsilon=eps, delta=delta,
            logical_batch=logical_eff, microbatch=physical,
            accumulation_steps=accum, data_shards=data_shards,
        )
    return 0


# Deterministic failure classes: a config/shape/assertion error fails
# identically on every attempt, so restarting it only burns the budget a
# real transient (preempted host, flaky storage, injected crash) needs.
_NON_RETRYABLE = (
    AssertionError,
    ValueError,
    TypeError,
    KeyError,
    AttributeError,
    ImportError,
    NotImplementedError,
)


def is_retryable_failure(exc: BaseException) -> bool:
    """Should the --auto-restart supervisor retry after ``exc``?  Not after
    the config-error types above (``--consensus``'s refusal included)."""
    return not isinstance(exc, _NON_RETRYABLE)


def main(argv=None, *, arch: Optional[ArchConfig] = None) -> int:
    args = parse_args(argv)
    reconfigure()  # re-apply $REPRO_LOG_LEVEL to module-level loggers
    # ONE injection plan for the whole supervision loop: injectors are
    # one-shot, so a crash that already fired does not re-fire after the
    # in-process restart (no args surgery needed)
    injection = _injection_for(args)
    if args.auto_restart <= 0:
        return run_once(args, injection, arch=arch)
    attempts = 0
    while True:
        try:
            return run_once(args, injection, arch=arch)
        except Exception as e:  # noqa: BLE001 — supervision loop
            if not is_retryable_failure(e):
                log.error(
                    "non-retryable failure (%s: %s): a deterministic "
                    "config/assertion error would fail every attempt — not "
                    "burning the %d-restart budget",
                    type(e).__name__, e, args.auto_restart,
                )
                raise
            attempts += 1
            if attempts > args.auto_restart:
                log.error("giving up after %d restarts", attempts - 1)
                raise
            log.warning("run failed (%s); auto-restart %d/%d from latest checkpoint",
                        e, attempts, args.auto_restart)
            # the crashed attempt's sinks are still installed (configure_run
            # keeps them for the same dir), so this lands in the same stream
            obs.emit_event(
                "restart_attempt", attempt=attempts,
                max_attempts=args.auto_restart,
                error=f"{type(e).__name__}: {e}",
            )
            args = argparse.Namespace(**vars(args))
            args.resume = True
            time.sleep(0.5)


if __name__ == "__main__":
    sys.exit(main())
