"""The DP train step and the greedy decode step (port of ``launch/steps.py``).

``make_train_step`` is the paper's full mechanism: per-sample clipping
(mixed ghost or book-keeping) + Gaussian noise + optimizer update.  PyTorch
runs it eagerly; the step enqueues device work and returns its metrics as
device tensors, so it never waits for the device itself.  The gradient
accumulation steps come with a later slice.  ``make_decode_step`` is
the serving engine's greedy step.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.core.clipping import ClipConfig, _batch_mask, dp_value_and_clipped_grad
from repro_torch.core.noise import add_dp_noise
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.optim.optimizers import Optimizer, apply_updates
from repro_torch.utils.tree import flatten_dict, tree_map


@dataclasses.dataclass(frozen=True)
class DPTrainConfig:
    clipping_mode: str = "mixed_ghost"
    clip_norm: float = 1.0
    clip_fn: str = "abadi"
    noise_multiplier: float = 1.0
    logical_batch: int = 256  # denominator for the privatized mean
    # clipping policy (repro_torch.policies.ClipPolicy); None builds the
    # fixed flat-R policy from (clip_norm, clip_fn)
    policy: Optional[Any] = None


def _policy_for(dp: DPTrainConfig):
    if dp.policy is not None:
        return dp.policy
    from repro_torch.policies.fixed import FixedPolicy

    return FixedPolicy(clip_norm=dp.clip_norm, clip_fn=dp.clip_fn)


def make_train_state(model, seed: int, optimizer: Optimizer, policy: Any = None) -> dict:
    """Parameters from ``seed`` on the model's device, optimizer state, the
    step counter, and the generator the step draws its noise from."""
    if policy is None:
        from repro_torch.policies.fixed import FixedPolicy

        policy = FixedPolicy()
    dev = model.device
    params = model.init(torch.Generator(device=dev).manual_seed(seed))
    return {
        "params": params,
        "opt": optimizer.init(params),
        "step": 0,
        "rng": torch.Generator(device=dev).manual_seed(seed + 1),
        "policy": policy.init_state(),
    }


def make_train_step(
    model,
    optimizer: Optimizer,
    schedule: Callable[[int], float],
    dp: DPTrainConfig,
    device: DeviceLike = None,
) -> Callable:
    """Full DP step: clip (policy factors) -> noise -> optimizer update.

    ``device`` is where the step runs (None: the GPU); it must be the
    model's.  The noise std uses the pre-update policy state, then the
    policy update runs.
    """
    dev = resolve_device(device)
    if dev != model.device:
        raise ValueError(f"train step on {dev} but the model lives on {model.device}")
    policy = _policy_for(dp)
    clip_cfg = ClipConfig(
        mode=dp.clipping_mode, clip_norm=dp.clip_norm, clip_fn=dp.clip_fn, policy=policy,
    )
    grad_fn = dp_value_and_clipped_grad(model.loss_with_ctx, clip_cfg)

    def train_step(state: dict, batch: Any) -> tuple[dict, dict]:
        for name, x in flatten_dict(batch).items():
            if x.device != dev:
                raise ValueError(f"batch[{name!r}] on {x.device}, the step runs on {dev}")
        pstate = state.get("policy", policy.init_state())
        loss, grad_sum, aux = grad_fn(state["params"], batch, pstate)
        if dp.clipping_mode == "non_private":
            grads = tree_map(lambda g: g.float(), grad_sum)
            new_pstate = pstate
        else:
            std = dp.noise_multiplier * policy.sensitivity(pstate)
            noisy = add_dp_noise(grad_sum, state["rng"], std)
            grads = tree_map(lambda g: g.float() / dp.logical_batch, noisy)
            new_pstate, _ = policy.update(
                pstate, aux["per_sample_norms"], generator=state["rng"],
                mask=_batch_mask(batch),
            )
        lr = schedule(state["step"])
        with torch.no_grad():
            updates, opt_state = optimizer.update(
                grads, state["opt"], state["params"], state["step"], lr
            )
            params = apply_updates(state["params"], updates)
        new_state = {
            "params": params,
            "opt": opt_state,
            "step": state["step"] + 1,
            "rng": state["rng"],
            "policy": new_pstate,
        }
        norms = aux["per_sample_norms"]
        metrics = {
            "loss": loss,
            "lr": lr,
            "norm_mean": norms.mean(),
            "norm_max": norms.max(),
            "clip_frac": (aux["clip_factors"] < 1.0).float().mean(),
            "clip_norm": policy.sensitivity(pstate),
        }
        return new_state, metrics

    return train_step


def make_decode_step(model) -> Callable:
    """(params, tokens (B, 1), state) -> (next tokens (B, 1), logits, state).

    Greedy: ``torch.argmax`` returns the first index of a tie, as
    ``jnp.argmax`` does.
    """

    def decode_step(params, tokens: torch.Tensor, state: dict):
        logits, state = model.decode_step(params, tokens, state)
        return logits[:, -1:].argmax(dim=-1), logits, state

    return decode_step
