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
the ``target_epsilon`` search alike.  The tuner entry points (``tune``,
``use_plan``, ``recertify_max_batch``) come with the tuner's slice.
"""
from __future__ import annotations

import dataclasses
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
        self._clip_cfg = ClipConfig(
            mode=self.mode,
            clip_norm=self.max_grad_norm,
            clip_fn=self.clip_fn,
            policy=self.clip_policy,
        )

    def _release_sigmas(self) -> tuple[float, ...]:
        ev = self.clip_policy.release_event()
        return (ev.release_sigma,) if ev.spends else ()

    def init_policy_state(self) -> Any:
        """The policy state the first step takes, on the engine's device."""
        return self.clip_policy.init_state(device=self.device)

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
