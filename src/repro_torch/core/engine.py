"""PrivacyEngine: the paper's Appendix-E API (port of ``core/engine.py``).

    engine = PrivacyEngine(loss_with_ctx=model.loss_with_ctx, batch_size=..., ...)
    grad_fn = engine.clipped_grad_fn()
    loss, g_sum, aux = grad_fn(params, batch)       # sum_i C_i g_i
    noisy = engine.privatize(g_sum, generator)      # + sigma R N(0, I), / batch
    engine.record_step()

``privatize`` adds noise once per *logical* batch and divides by the
logical batch size (the paper's virtual-step semantics).  ``mode`` is any
of ``clipping.MODES``; ``clip_policy`` any ClipPolicy (``make_policy``),
and a policy that releases a statistic each step (quantile) is composed
into the accountant beside the gradient mechanism, in ``epsilon`` and in
the ``target_epsilon`` search alike.

Measured-cost tuning (``repro_torch.tuner``): ``tune`` times the three-way
branch decision per tap on the engine's device, certifies the largest
physical batch under a memory budget by trial, and adopts (and by default
caches) the ``ClipPlan``; ``use_plan`` adopts one, ``recertify_max_batch``
searches again for the current mode and plan, and ``plan_event_fields`` is
the record of what a step runs.  ``check_epsilon_alarm`` emits the one-shot
``epsilon_budget_crossed`` event.  The fleet agreement (``tune``'s
``consensus=`` and ``gather_fn=``) comes with ``torch.distributed`` and
raises ``NotImplementedError`` until then.
"""
from __future__ import annotations

import dataclasses
import logging
import os
from typing import Any, Callable, Optional

import torch

from repro_torch.core.accountant import RDPAccountant, compute_epsilon, find_noise_multiplier
from repro_torch.core.clipping import (
    MODES,
    ClipConfig,
    discover_meta,
    dp_value_and_clipped_grad,
    validate_coverage,
)
from repro_torch.core.noise import add_dp_noise
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.utils.tree import tree_map

log = logging.getLogger("repro_torch.engine")

# the fleet agreement's refusal, shared by PrivacyEngine.tune and the tuner CLI
CONSENSUS_LATER = ("fleet consensus comes with the port of tuner/consensus.py over "
                   "torch.distributed, with parallel/, after the single-process "
                   "runtime around training")


@dataclasses.dataclass
class PrivacyEngine:
    loss_with_ctx: Callable  # (params, batch, ctx) -> (B,) per-sample losses
    batch_size: int  # logical batch size (samples per optimizer step)
    sample_size: int  # dataset size N
    max_grad_norm: float  # clipping norm R
    epochs: Optional[float] = None
    steps: Optional[int] = None
    target_epsilon: Optional[float] = None
    target_delta: Optional[float] = None
    noise_multiplier: Optional[float] = None
    mode: str = "mixed_ghost"  # paper: 'ghost-mixed'
    clip_fn: str = "abadi"
    frozen_prefixes: tuple[str, ...] = ()
    clip_policy: Optional[Any] = None
    # measured-cost branch plan (repro_torch.tuner.ClipPlan); set directly,
    # through use_plan(), or made in place by tune()
    plan: Optional[Any] = None
    # the device the parameters and batches live on: None is the GPU (and
    # raises without one); "cpu" must be asked for
    device: DeviceLike = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.mode not in MODES:
            raise ValueError(f"unknown clipping mode {self.mode!r}; have {MODES}")
        self.sampling_rate = self.batch_size / self.sample_size
        if self.steps is None:
            if self.epochs is None:
                raise ValueError("need epochs or steps")
            self.steps = int(self.epochs * self.sample_size / self.batch_size)
        if self.target_delta is None:
            self.target_delta = 1.0 / (2 * self.sample_size)
        if self.clip_policy is None:
            from repro_torch.policies.fixed import FixedPolicy

            self.clip_policy = FixedPolicy(clip_norm=self.max_grad_norm, clip_fn=self.clip_fn)
        if self.noise_multiplier is None:
            if self.target_epsilon is None:
                raise ValueError("need target_epsilon or noise_multiplier")
            self.noise_multiplier = find_noise_multiplier(
                target_epsilon=self.target_epsilon,
                q=self.sampling_rate,
                steps=self.steps,
                delta=self.target_delta,
                release_sigmas=self._release_sigmas(),
            )
        self.accountant = RDPAccountant()
        self._eps_alarm_fired = False
        self._clip_cfg = ClipConfig(
            mode=self.mode,
            clip_norm=self.max_grad_norm,
            clip_fn=self.clip_fn,
            plan=self.plan,
            policy=self.clip_policy,
        )

    def _release_sigmas(self) -> tuple[float, ...]:
        ev = self.clip_policy.release_event()
        return (ev.release_sigma,) if ev.spends else ()

    def init_policy_state(self) -> Any:
        """The policy state the first step takes, on the engine's device."""
        return self.clip_policy.init_state(device=self.device)

    # -- measured-cost autotuning -----------------------------------------
    def use_plan(self, plan: Any) -> None:
        """Adopt a tuner ClipPlan; later clipped_grad_fn() calls use it."""
        self.plan = plan
        self._clip_cfg = dataclasses.replace(self._clip_cfg, plan=plan)

    def recertify_max_batch(self, params: Any, batch: Any, *, hi_cap: int = 4096
                            ) -> Optional[Any]:
        """Search the max physical batch again for the CURRENT mode and plan.

        A certificate holds for the step it was searched with: another mode
        (book-keeping banks what the searched step never allocated) or
        flipped branches void it.  Returns the plan with a refreshed
        ``physical_batch`` (adopted), the plan unchanged when the certificate
        holds, or ``None`` when nothing fits the stored budget: the caller
        must then fall back rather than train uncertified.
        """
        plan = self.plan
        if plan is None or not getattr(plan, "budget_bytes", None):
            return plan
        from repro_torch.tuner import max_batch as _mb

        mp, method = _mb.certify_max_batch(
            self.clipped_grad_fn(), params, batch, budget_bytes=plan.budget_bytes,
            hi_cap=hi_cap, reserved_bytes=_mb.resident_state_bytes(params),
        )
        if mp <= 0:
            return None
        if mp != plan.physical_batch:
            _, steps = _mb.derive_accumulation(self.batch_size, mp)
            log.info("re-certified max physical batch under %s by %s: %d (was %s)",
                     self.mode, method, mp, plan.physical_batch)
            plan = plan.replace_batch(physical_batch=mp, logical_batch=self.batch_size,
                                      accumulation_steps=steps, budget_bytes=plan.budget_bytes)
            self.use_plan(plan)
        return plan

    def tune(
        self,
        params: Any,
        batch: Any,
        *,
        arch: Optional[str] = None,
        measure: Optional[Any] = None,
        search_max_batch: bool = True,
        budget_bytes: Optional[int] = None,
        hi_cap: int = 4096,
        plan_path: Optional[str] = "auto",
        use_cache: bool = True,
        remeasure_at_physical: bool = True,
        consensus: bool = False,
        gather_fn: Optional[Callable] = None,
    ) -> Any:
        """Time the three-way branch decision per tap on the engine's device,
        certify the max physical microbatch, adopt and (by default) cache the
        ClipPlan; returns it.

        Each matmul tap is timed on {ghost norm, instantiated norm,
        book-keeping ghost bank, book-keeping psg bank, second-backward
        share}; the plan carries a branch map per tuned mode and a measured
        ``recommended_mode``.  After the search, ``remeasure_at_physical``
        re-times the branches at the certified batch until branches and batch
        agree.  A valid cached plan for this (arch, device, tap shapes,
        budget) is adopted without measuring (``use_cache=False`` forces a
        fresh one).  ``plan_path="auto"`` writes to the tuner's cache
        directory, ``None`` writes nothing.  The clipped gradients under the
        plan equal the analytic decision's: a plan moves cost, never math.
        """
        if consensus or gather_fn is not None:
            raise NotImplementedError(CONSENSUS_LATER)
        from repro_torch.tuner import max_batch as _mb
        from repro_torch.tuner.measure import (
            MeasureConfig,
            build_plan,
            close_physical_batch_loop,
        )
        from repro_torch.tuner.plan import ClipPlan, default_plan_path, load_cached_plan

        budget = _mb.DEFAULT_BUDGET_BYTES if budget_bytes is None else budget_bytes
        meta = discover_meta(self.loss_with_ctx, params, batch)
        policy_fp = self.clip_policy.fingerprint()

        def stamp(p):
            # plans carry the policy's identity (a fleet cannot certify one
            # plan across policies); re-stamping voids an agreement claim
            if p is None or p.policy_fingerprint == policy_fp:
                return p
            cleared = {} if p.agreed_hash is None else {"agreed_hash": None,
                                                         "agreed_ranks": None}
            return dataclasses.replace(p, policy_fingerprint=policy_fp, **cleared)

        if use_cache:
            cached = None
            if plan_path == "auto":
                cached = load_cached_plan(arch, meta)
            elif plan_path is not None and os.path.exists(plan_path):
                try:
                    cached = ClipPlan.load(plan_path)
                except (ValueError, KeyError) as e:
                    log.warning("ignoring unreadable plan %s (%s); re-tuning", plan_path, e)
            # a cached max batch holds for the budget it was searched under
            budget_ok = not search_max_batch or (
                cached is not None and cached.budget_bytes == budget)
            if cached is not None and budget_ok and cached.matches(meta, self.device):
                cached = stamp(cached)
                self.use_plan(cached)
                return cached
        measure_cfg = measure or MeasureConfig()
        plan = stamp(build_plan(meta, measure=measure_cfg, arch=arch, device=self.device))
        if search_max_batch:
            def search(p) -> int:
                grad_fn = dp_value_and_clipped_grad(
                    self.loss_with_ctx, dataclasses.replace(self._clip_cfg, plan=p))
                mp, method = _mb.certify_max_batch(
                    grad_fn, params, batch, budget_bytes=budget, hi_cap=hi_cap,
                    reserved_bytes=_mb.resident_state_bytes(params))
                log.info("max physical batch certified by %s: %d", method, mp)
                return mp

            mp = search(plan)
            if mp > 0:
                _, steps = _mb.derive_accumulation(self.batch_size, mp)
                plan = plan.replace_batch(physical_batch=mp, logical_batch=self.batch_size,
                                          accumulation_steps=steps, budget_bytes=budget)
                if remeasure_at_physical:
                    # the step runs at the certified batch, so the branches
                    # are measured there; flips move memory, so the two
                    # converge together
                    plan = close_physical_batch_loop(
                        plan, meta, search, self.batch_size, budget, measure_cfg,
                        device=self.device)
        if plan_path is not None:
            plan.save(default_plan_path(arch, plan.fingerprint)
                      if plan_path == "auto" else plan_path)
        self.use_plan(plan)
        return plan

    def plan_event_fields(self) -> dict:
        """The ``plan_adopted`` record of this engine's clipping: the per-tap
        branch decision of the running mode, the kernel per (tap, op) and the
        batch certificate; with no plan, the analytic rule, said so.  Plain
        JSON-able values only."""
        out = {
            "mode": self.mode,
            "policy": self.clip_policy.fingerprint(),
            "clip_norm": float(self.max_grad_norm),
            "noise_multiplier": float(self.noise_multiplier),
        }
        plan = self.plan
        if plan is None:
            out["source"] = "analytic"
            return out
        out.update(
            source="plan",
            branches=plan.branch_map(self.mode),
            kernels=plan.kernel_map(),
            recommended_mode=plan.recommended_mode(),
            physical_batch=plan.physical_batch,
            accumulation_steps=plan.accumulation_steps,
            plan_device=plan.device,
            consensus_hash=plan.consensus_hash(),
            agreed_hash=plan.agreed_hash,
            agreed_ranks=plan.agreed_ranks,
        )
        return out

    def validate(self, params: Any, batch: Any) -> None:
        """Raise if any trainable parameter escapes per-sample clipping."""
        meta = discover_meta(self.loss_with_ctx, params, batch)
        missing = validate_coverage(meta, params, self.frozen_prefixes)
        if missing:
            raise ValueError(
                "parameters not covered by per-sample clipping (freeze them or "
                f"add taps): {missing[:10]}{'...' if len(missing) > 10 else ''}"
            )

    def clipped_grad_fn(self) -> Callable:
        """(params, batch) -> (mean_loss, sum_i C_i g_i, aux)."""
        return dp_value_and_clipped_grad(self.loss_with_ctx, self._clip_cfg)

    def privatize(
        self, grad_sum: Any, generator: torch.Generator, policy_state: Any = None
    ) -> Any:
        """Add sigma * sensitivity * N(0, I) once per logical batch, then
        divide by the logical batch size.  ``generator`` lives on the
        gradients' device."""
        pstate = policy_state if policy_state is not None else self.init_policy_state()
        std = self.noise_multiplier * self.clip_policy.sensitivity(pstate)
        noisy = add_dp_noise(grad_sum, generator, std)
        return tree_map(lambda g: (g.float() / self.batch_size).to(g.dtype), noisy)

    def record_step(self, n: int = 1) -> None:
        """Compose n steps, one at a time (gradient, then any policy release),
        so a replay performs the identical float additions."""
        for _ in range(n):
            self.accountant.step(q=self.sampling_rate, sigma=self.noise_multiplier, steps=1)
            for rs in self._release_sigmas():
                self.accountant.step(q=self.sampling_rate, sigma=rs, steps=1)

    def check_epsilon_alarm(self, fraction: float, step: Optional[int] = None) -> bool:
        """One-shot budget alarm: emit ``epsilon_budget_crossed`` once the
        accountant's spend passes ``fraction * target_epsilon``.

        Returns True iff the alarm fired on THIS call: the latch keeps it to
        one event per engine, so drivers may call this after every
        ``record_step``.  A no-op when the run has no ``target_epsilon`` or
        ``fraction <= 0``.
        """
        if self._eps_alarm_fired or self.target_epsilon is None or fraction <= 0:
            return False
        eps, delta = self.privacy_spent()
        if eps < fraction * self.target_epsilon:
            return False
        self._eps_alarm_fired = True
        from repro_torch.obs import events as obs

        obs.emit_event(
            "epsilon_budget_crossed",
            step=step,
            epsilon=float(eps),
            delta=float(delta),
            target_epsilon=float(self.target_epsilon),
            fraction=float(fraction),
        )
        log.warning("privacy budget alarm: epsilon %.4f passed %.0f%% of target %.4f",
                    eps, 100 * fraction, self.target_epsilon)
        return True

    def privacy_spent(self, steps: Optional[int] = None) -> tuple[float, float]:
        if steps is not None:
            eps = compute_epsilon(
                q=self.sampling_rate,
                sigma=self.noise_multiplier,
                steps=steps,
                delta=self.target_delta,
                release_sigmas=self._release_sigmas(),
            )
        else:
            eps = self.accountant.get_epsilon(self.target_delta)
        return eps, self.target_delta
