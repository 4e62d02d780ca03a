"""The DP train step, gradient accumulation and the greedy decode step
(port of ``launch/steps.py``).

``make_train_step`` is the paper's full mechanism: per-sample clipping
(mixed ghost or book-keeping) + Gaussian noise + optimizer update.  PyTorch
runs it eagerly; the step enqueues device work and returns its metrics as
device tensors, so it never waits for the device itself.

Gradient accumulation (the paper's virtual step): a logical batch of
``accumulation_steps`` physical microbatches.  ``make_accum_init`` makes the
accumulator (fp32 gradient buffers, the loss and clip-hit counters, and
``(logical,)`` norm and mask buffers); ``make_accum_microstep`` clips a
microbatch under the step's policy state and folds it in place (``add_``,
the norms and mask copied in at ``idx * physical``), with no host sync;
``make_accum_finalize`` (around ``make_noise_finalize``) draws the noise
once per logical batch, runs the one policy update from ``state["rng"]``
and applies the optimizer; ``make_train_step`` runs the same tail after its
one clipped call.  Where the JAX
package donates its accumulator through jitted programs, the port writes
into the same tensors.  ``make_prefill_step`` and ``make_decode_step`` are
the serving steps (the decode greedy).

The sharded step (data parallelism with FSDP of the parameters and the
optimizer moments): every train-step builder takes ``shardings``, the
state's placements (``parallel.sharding.state_shardings``), as the JAX
package's jitted step takes them as ``in_shardings``, and then runs inside
``parallel.reshard.use_reshard_rules`` on a live mesh.  The state holds
this rank's shards of the parameters and moments (``parallel.fsdp``); the
step counter, the policy state and the generator are replicated.  Every
rank is given the same global batch and keeps its rows.  The per-sample
norms and clip factors are computed locally, since the gathered weights
put each sample's whole gradient on one rank; they are all-gathered, with
the loss, so the replicated policy update and the metrics see the global
batch.  The gradient sum comes back reduce-scattered (``fsdp.ShardLayout
.reduce_grads``); the noise is drawn full-size from the replicated
generator and each rank keeps its slice, so it equals the one-rank step's;
the optimizer updates the shards.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.core.clipping import ClipConfig, _batch_mask, dp_value_and_clipped_grad
from repro_torch.core.noise import add_dp_noise
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.optim.optimizers import Optimizer, apply_updates
from repro_torch.parallel import reshard
from repro_torch.parallel.fsdp import ShardLayout
from repro_torch.utils.tree import flatten_dict, tree_map


@dataclasses.dataclass(frozen=True)
class DPTrainConfig:
    clipping_mode: str = "mixed_ghost"
    clip_norm: float = 1.0
    clip_fn: str = "abadi"
    noise_multiplier: float = 1.0
    logical_batch: int = 256  # denominator for the privatized mean
    accumulation_steps: int = 1  # physical microbatches per logical batch
    # clipping policy (repro_torch.policies.ClipPolicy); None builds the
    # fixed flat-R policy from (clip_norm, clip_fn)
    policy: Optional[Any] = None
    # measured-cost branch plan (repro_torch.tuner.ClipPlan); threaded into
    # the clipping of every step (a stale plan gives the analytic rule)
    plan: Optional[Any] = None


def _policy_for(dp: DPTrainConfig):
    if dp.policy is not None:
        return dp.policy
    from repro_torch.policies.fixed import FixedPolicy

    return FixedPolicy(clip_norm=dp.clip_norm, clip_fn=dp.clip_fn)


def _layout(shardings: Any) -> Optional[ShardLayout]:
    """The data-axis layout of a sharded step (None: the one-process step)."""
    if shardings is None:
        return None
    mesh = reshard.active_mesh()
    if mesh is None or not mesh.live:
        raise ValueError("a sharded step runs inside use_reshard_rules(mesh) on a live mesh "
                         "(launch.mesh.make_host_mesh)")
    return ShardLayout(mesh, shardings["params"])


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
        "policy": policy.init_state(device=dev),
    }


def make_train_step(
    model,
    optimizer: Optimizer,
    schedule: Callable[[int], float],
    dp: DPTrainConfig,
    device: DeviceLike = None,
    shardings: Any = None,
) -> Callable:
    """Full DP step: clip (policy factors) -> noise -> optimizer update.

    ``device`` is where the step runs (None: the GPU); it must be the
    model's.  The noise std uses the pre-update policy state, then the
    policy update runs.  ``shardings``: the sharded step (module docstring).
    """
    dev = resolve_device(device)
    if dev != model.device:
        raise ValueError(f"train step on {dev} but the model lives on {model.device}")
    policy = _policy_for(dp)
    grad_fn = make_clipped_microstep(model, dp, shardings=shardings)
    finalize = make_noise_finalize(optimizer, schedule, dp, shardings=shardings)

    def train_step(state: dict, batch: Any) -> tuple[dict, dict]:
        for name, x in flatten_dict(batch).items():
            if x.device != dev:
                raise ValueError(f"batch[{name!r}] on {x.device}, the step runs on {dev}")
        pstate = state.get("policy", policy.init_state(device=dev))
        loss, grad_sum, aux = grad_fn(state["params"], batch, pstate)
        norms, factors = aux["per_sample_norms"], aux["clip_factors"]
        new_state = finalize(state, grad_sum, norms, _batch_mask(batch))
        metrics = {
            "loss": loss,
            "lr": schedule(state["step"]),
            "norm_mean": norms.mean(),
            "norm_max": norms.max(),
            "clip_frac": (factors < 1.0).float().mean(),
            "clip_norm": policy.sensitivity(pstate),
        }
        return new_state, metrics

    return train_step


def make_clipped_microstep(model, dp: DPTrainConfig, shardings: Any = None) -> Callable:
    """Gradient-accumulation half: (params, batch, policy_state) -> (loss,
    clipped grad SUM, aux).  Every microstep of a logical batch runs under
    the same policy state; ``make_noise_finalize`` adds the noise and runs
    the one policy update.

    With ``shardings`` it takes the global batch and this rank's parameter
    shards and clips this rank's rows; it returns the global mean loss,
    this rank's shards of the fleet's gradient sum, and the global batch's
    per-sample norms and clip factors (all-gathered in rank order)."""
    clip_cfg = ClipConfig(
        mode=dp.clipping_mode, clip_norm=dp.clip_norm, clip_fn=dp.clip_fn,
        plan=dp.plan, policy=_policy_for(dp),
    )
    grad_fn = dp_value_and_clipped_grad(model.loss_with_ctx, clip_cfg)
    if shardings is None:
        return grad_fn

    def sharded(params, batch, policy_state=None):
        layout = _layout(shardings)
        loss, g, aux = grad_fn(params, layout.local_rows(batch), policy_state,
                               shapes=layout.full_shapes(params))
        return layout.mean(loss), layout.reduce_grads(g, params), {
            "per_sample_norms": layout.gather_rows(aux["per_sample_norms"]),
            "clip_factors": layout.gather_rows(aux["clip_factors"]),
        }

    return sharded


def make_accum_init(grad_spec: Any, n_samples: int) -> Callable:
    """Zero accumulator for one logical batch: () -> acc.

    ``grads`` mirrors ``grad_spec`` (the parameters, or any tree of tensors
    of their shapes) in fp32 on its device; ``norms`` and ``mask`` are flat
    ``(n_samples,)`` buffers the microsteps copy into, so the policy update
    sees the whole logical batch without a concatenation.
    """
    device = next(iter(flatten_dict(grad_spec).values())).device

    def init() -> dict:
        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=device)

        return {
            "grads": tree_map(lambda s: zeros(*s.shape), grad_spec),
            "loss": zeros(),
            "clip_hits": zeros(),
            "norms": zeros(n_samples),
            "mask": zeros(n_samples),
        }

    return init


def make_accum_microstep(model, dp: DPTrainConfig, shardings: Any = None) -> Callable:
    """Accumulating microstep: (params, policy_state, acc, batch, idx) -> acc.

    Clips one microbatch and folds it into the logical-batch accumulator in
    place: the gradient sum, the loss and clip-hit counters, and the
    per-sample norms and Poisson mask copied in at microstep ``idx``'s
    offset.  It enqueues device work only: no host sync.  ``shardings``:
    the sharded microstep, whose gradient sum is reduced each microstep
    (the accumulator holds shards) and whose norms are the global
    microbatch's.
    """
    grad_fn = make_clipped_microstep(model, dp, shardings=shardings)

    def micro(params, policy_state, acc: dict, batch: Any, idx: int) -> dict:
        loss, g, aux = grad_fn(params, batch, policy_state)
        norms, factors = aux["per_sample_norms"], aux["clip_factors"]
        physical = norms.shape[0]
        rows = slice(idx * physical, (idx + 1) * physical)
        flat_g = flatten_dict(g)
        with torch.no_grad():
            for path, buf in flatten_dict(acc["grads"]).items():
                buf.add_(flat_g[path])
            acc["loss"].add_(loss)
            acc["clip_hits"].add_((factors < 1.0).float().sum())
            acc["norms"][rows].copy_(norms)
            m = _batch_mask(batch)
            if m is None:
                acc["mask"][rows].fill_(1.0)
            else:
                acc["mask"][rows].copy_(m)
        return acc

    return micro


def make_accum_finalize(
    optimizer: Optimizer, schedule: Callable[[int], float], dp: DPTrainConfig,
    shardings: Any = None,
) -> Callable:
    """Logical-batch finalize over the accumulator: (state, acc) -> (state,
    metrics).  The metrics are device tensors over the whole logical batch;
    reading one is the only sync, once per logical batch."""
    base = make_noise_finalize(optimizer, schedule, dp, shardings=shardings)

    def finalize(state: dict, acc: dict) -> tuple[dict, dict]:
        metrics = {
            "loss": acc["loss"] / dp.accumulation_steps,
            "lr": schedule(state["step"]),
            "clip_frac": acc["clip_hits"] / dp.logical_batch,
            "norm_mean": acc["norms"].mean(),
            "norm_max": acc["norms"].max(),
        }
        new_state = base(state, acc["grads"], acc["norms"], acc["mask"])
        return new_state, metrics

    return finalize


def make_noise_finalize(
    optimizer: Optimizer, schedule: Callable[[int], float], dp: DPTrainConfig,
    shardings: Any = None,
) -> Callable:
    """Noise + update once per logical batch: (state, grad_sum, norms=None,
    mask=None) -> state.

    ``norms``/``mask`` are the whole logical batch's per-sample norms and
    Poisson mask; they feed the policy update, one release per noise
    addition, so the quantile policy spends exactly once per accounted step.
    The noise is drawn first, then the update, both from ``state["rng"]``;
    ``make_train_step`` calls this after its clipped call, so the two share
    one noise-then-update order.  ``norms=None`` skips the update.  With
    ``shardings`` the gradient and state hold this rank's shards, and each
    leaf's noise is this rank's slice of the full-size draw.
    """
    policy = _policy_for(dp)

    def finalize(state: dict, grad_sum: Any, norms: Optional[torch.Tensor] = None,
                 mask: Optional[torch.Tensor] = None) -> dict:
        dev = state["rng"].device
        pstate = state.get("policy", policy.init_state(device=dev))
        if dp.clipping_mode == "non_private":
            grads = tree_map(lambda g: g.float(), grad_sum)
            new_pstate = pstate
        else:
            std = dp.noise_multiplier * policy.sensitivity(pstate)
            noisy = add_dp_noise(grad_sum, state["rng"], std, layout=_layout(shardings))
            # the noisy tree is this call's own: divided in place, the update
            # holds one model-sized tree fewer at its peak
            grads = tree_map(lambda g: g.float().div_(dp.logical_batch), noisy)
            new_pstate = pstate
            if norms is not None:
                new_pstate, _ = policy.update(pstate, norms, generator=state["rng"], mask=mask)
        lr = schedule(state["step"])
        with torch.no_grad():
            updates, opt_state = optimizer.update(
                grads, state["opt"], state["params"], state["step"], lr
            )
            params = apply_updates(state["params"], updates)
        return {
            "params": params,
            "opt": opt_state,
            "step": state["step"] + 1,
            "rng": state["rng"],
            "policy": new_pstate,
        }

    return finalize


def make_prefill_step(model) -> Callable:
    """(params, batch, state) -> (last-position logits (B, 1, V), state)."""

    def prefill_step(params, batch: dict, state: dict):
        return model.prefill(params, batch, state)

    return prefill_step


def make_decode_step(model) -> Callable:
    """(params, tokens (B, 1), state) -> (next tokens (B, 1), logits, state).

    Greedy: ``torch.argmax`` returns the first index of a tie, as
    ``jnp.argmax`` does.
    """

    def decode_step(params, tokens: torch.Tensor, state: dict):
        logits, state = model.decode_step(params, tokens, state)
        return logits[:, -1:].argmax(dim=-1), logits, state

    return decode_step
