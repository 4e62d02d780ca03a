"""Per-sample gradient clipping engines (port of ``core/clipping.py``).

The model exposes ``loss_with_ctx(params, batch, ctx) -> per_sample_losses``;
everything else happens here.  Every mode is a ``ClipExecutor``, one
three-stage pipeline

    norms stage    -> per-sample squared norms (mode-specific machinery)
    factor stage   -> C_i = clip_fn(||g_i||, R) * mask      (the ClipPolicy)
    gradient stage -> sum_i C_i g_i                         (mode-specific)

Modes in this slice:

- ``ghost`` / ``fastgradclip`` / ``mixed_ghost``  the fused probes compute
  the norms inside the first backward (ghost norm everywhere / instantiation
  everywhere / the paper's Eq-(4.1) layerwise choice, Alg. 1), then a second
  backward over the same graph with the clip factors as the loss cotangent
  gives the clipped gradient sum: 1 forward + 2 backward.
- ``bk_mixed``  book-keeping (arXiv:2210.00038): the probes also bank the
  residuals, and the gradient stage contracts the banks with the clip
  factors; no second backward.
- ``non_private``  C_i = 1, the baseline.

``vmap`` and the ``*_taps`` reference executors come with a later slice.

Flow of the fused family (``FusedExecutor``)::

    losses = model(params, batch, ctx)              # probes record a per tap
    grad(losses, inputs=zs, grad_outputs=ones)      # 1st backward: banks only,
                                                    # param-grad kernels pruned
    C = policy(sqrt(sum_tap banks[tap]["n"])) * mask
    grad(losses, inputs=params, grad_outputs=C)     # 2nd backward (not bk_mixed)
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import torch

from repro_torch.core import ghost
from repro_torch.core.taps import ClipRuntime, Ctx, TapMeta, bank_keys
from repro_torch.kernels import dispatch
from repro_torch.utils.tree import flatten_dict, unflatten_dict

LossFn = Callable[..., torch.Tensor]  # (params, batch, ctx) -> (B,) losses

MODES = ("ghost", "fastgradclip", "mixed_ghost", "bk_mixed", "non_private")
LATER_MODES = (
    "vmap", "ghost_taps", "fastgradclip_taps", "mixed_ghost_taps", "bk_mixed_taps",
)


@dataclasses.dataclass(frozen=True)
class ClipConfig:
    mode: str = "mixed_ghost"
    clip_norm: float = 1.0
    clip_fn: str = "abadi"
    # clipping policy (repro_torch.policies.ClipPolicy); None builds the
    # fixed flat-R policy from (clip_norm, clip_fn)
    policy: Optional[Any] = None


def discover_meta(loss_with_ctx: LossFn, params: Any, batch: Any) -> dict[str, TapMeta]:
    """Run the forward once, without autograd, to enumerate the taps."""
    meta: dict[str, TapMeta] = {}
    with torch.no_grad():
        loss_with_ctx(params, batch, Ctx(meta=meta))
    return meta


def validate_coverage(
    meta: dict[str, TapMeta], params: Any, frozen_prefixes: tuple[str, ...] = ()
) -> list[str]:
    """Every trainable param leaf must be covered by exactly one tap.

    Duplicate coverage would double-count a leaf's per-sample norm, so it
    raises here.  Returns the sorted list of uncovered paths (callers raise
    unless the leaf is declared frozen: an uncovered leaf escapes clipping).
    """
    claimed: dict[str, list[str]] = {}
    for name, m in meta.items():
        claimed.setdefault(m.param_path, []).append(name)
        if m.bias_path:
            claimed.setdefault(m.bias_path, []).append(name)
    duplicates = {path: names for path, names in claimed.items() if len(names) > 1}
    if duplicates:
        detail = "; ".join(
            f"{path} <- taps {sorted(names)}" for path, names in sorted(duplicates.items())
        )
        raise ValueError(
            "duplicate per-sample clipping coverage (norms would be "
            f"double-counted): {detail}"
        )
    return sorted(
        path for path in flatten_dict(params)
        if path not in claimed and not any(path.startswith(p) for p in frozen_prefixes)
    )


def _batch_mask(batch: Any) -> Optional[torch.Tensor]:
    return batch.get("mask") if isinstance(batch, dict) else None


def _leaves_requiring_grad(params: Any) -> tuple[dict[str, torch.Tensor], Any]:
    """Fresh autograd leaves sharing the parameters' storage."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in flatten_dict(params).items()}
    return leaves, unflatten_dict(leaves)


def _param_grads(losses, leaves: dict[str, torch.Tensor], cotangent) -> Any:
    grads = torch.autograd.grad(
        losses, list(leaves.values()), grad_outputs=cotangent.to(losses.dtype),
        allow_unused=True,
    )
    return unflatten_dict({
        k: torch.zeros_like(v) if gr is None else gr
        for (k, v), gr in zip(leaves.items(), grads)
    })


@dataclasses.dataclass
class _NormState:
    """What the norms stage hands the gradient stage (one step's plumbing)."""

    losses: torch.Tensor
    norms2: torch.Tensor
    leaves: Optional[dict[str, torch.Tensor]] = None  # second-backward modes
    runtime: Optional[ClipRuntime] = None  # the probes' phase flag and banks
    meta: Optional[dict[str, TapMeta]] = None


class ClipExecutor:
    """Template for every clipping mode: norms -> clip factors -> gradients.

    ``fn(params, batch, policy_state=None) -> (mean_loss, clipped_grad_sum,
    aux)`` with aux = {"per_sample_norms": (B,), "clip_factors": (B,)}.
    Noise is added downstream by the privacy engine.
    """

    def __init__(self, loss_with_ctx: LossFn, cfg: ClipConfig):
        self.loss = loss_with_ctx
        self.cfg = cfg
        if cfg.policy is not None:
            self.policy = cfg.policy
        else:
            from repro_torch.policies.fixed import FixedPolicy

            self.policy = FixedPolicy(clip_norm=cfg.clip_norm, clip_fn=cfg.clip_fn)

    def _norm_state(self, params, batch) -> _NormState:
        raise NotImplementedError

    def _clip_factors(self, norms, mask, pstate) -> torch.Tensor:
        c = self.policy.clip_factors(norms, pstate)
        if mask is not None:
            c = c * mask.to(c.dtype)
        return c.detach()

    def _weighted_grads(self, st: _NormState, c, params) -> Any:
        raise NotImplementedError

    def __call__(self, params, batch, policy_state=None):
        mask = _batch_mask(batch)
        st = self._norm_state(params, batch)
        norms = torch.sqrt(st.norms2)
        pstate = policy_state if policy_state is not None else self.policy.init_state()
        c = self._clip_factors(norms, mask, pstate)
        grads = self._weighted_grads(st, c, params)
        loss = st.losses.detach().sum() / st.losses.shape[0]
        return loss, grads, {"per_sample_norms": norms, "clip_factors": c}


class NonPrivateExecutor(ClipExecutor):
    """C_i = 1 for all i: plain summed gradients through the same skeleton."""

    def _norm_state(self, params, batch) -> _NormState:
        leaves, p = _leaves_requiring_grad(params)
        losses = self.loss(p, batch, Ctx.disabled())
        return _NormState(
            losses=losses,
            norms2=torch.zeros(losses.shape[0], dtype=torch.float32, device=losses.device),
            leaves=leaves,
        )

    def _clip_factors(self, norms, mask, pstate):
        return torch.ones_like(norms)

    def _weighted_grads(self, st, c, params):
        return _param_grads(st.losses, st.leaves, c)


class FusedExecutor(ClipExecutor):
    """Probe engine: norms (and bk banks) computed inside the backward pass.

    Covers ghost / fastgradclip / mixed_ghost (gradient stage = second
    backward over the retained graph) and bk_mixed (gradient stage = bank
    contractions; the single backward is all the backpropagation there is).
    """

    @property
    def is_bk(self) -> bool:
        return self.cfg.mode == "bk_mixed"

    def _norm_state(self, params, batch) -> _NormState:
        cfg = self.cfg
        runtime = ClipRuntime(mode=cfg.mode)
        leaves = None
        if not self.is_bk:
            leaves, params = _leaves_requiring_grad(params)
        ctx = Ctx(meta={}, clip=runtime)
        losses = self.loss(params, batch, ctx)
        # first backward: gradients of the probes' dummy leaves only, so
        # autograd runs every probe and prunes every parameter-gradient kernel
        torch.autograd.grad(
            losses, list(ctx.zs.values()), grad_outputs=torch.ones_like(losses),
            retain_graph=not self.is_bk,
        )
        runtime.phase = "grad"
        b = losses.shape[0]
        norms2 = torch.zeros(b, dtype=torch.float32, device=losses.device)
        for name, m in ctx.meta.items():  # a stacked tap: one bank per layer
            for key in bank_keys(name, m):
                norms2 = norms2 + runtime.banks[key]["n"]
        return _NormState(
            losses=losses.detach() if self.is_bk else losses,
            norms2=norms2, leaves=leaves, runtime=runtime, meta=ctx.meta,
        )

    def _weighted_grads(self, st, c, params):
        if not self.is_bk:
            return _param_grads(st.losses, st.leaves, c)  # second backward
        # book-keeping: contractions of the banks; nothing re-propagates.
        # A book contracts per tap; every psg bank of the step contracts in
        # one grouped call, its sums written to the parameter paths after
        flat_params = flatten_dict(params)
        flat_grads: dict[str, torch.Tensor] = {}

        def add(path, val):
            flat_grads[path] = flat_grads[path] + val if path in flat_grads else val

        segments = []
        for name, m in st.meta.items():
            banks = [st.runtime.banks.pop(k) for k in bank_keys(name, m)]
            shape = tuple(flat_params[m.param_path].shape)
            if "g" in banks[0]:
                book = _stack_banks(banks)
                for path, val in ghost.tap_weighted_grads(m, book["a"], book["g"], c,
                                                          shape).items():
                    add(path, val)
            else:
                segments.extend(ghost.psg_segments(m, banks, shape))
        if segments:
            sums = dispatch.psg_contract_grouped([x for _, _, xs in segments for x in xs], c)
            at = 0
            for path, shape, _ in segments:
                size = math.prod(shape)
                add(path, sums[at:at + size].reshape(shape))
                at += size
        for path, leaf in flat_params.items():
            if path not in flat_grads:
                flat_grads[path] = torch.zeros_like(leaf)
            else:
                flat_grads[path] = flat_grads[path].to(leaf.dtype)
        return unflatten_dict(flat_grads)


def _stack_banks(banks: list[dict[str, torch.Tensor]]) -> dict[str, torch.Tensor]:
    """One tap's per-layer (a, g) books, stacked in layer order (the norm
    ``n`` is already summed by the norms stage)."""
    if len(banks) == 1:
        return banks[0]
    return {k: torch.stack([bk[k] for bk in banks]) for k in banks[0] if k != "n"}


_EXECUTORS = {
    "non_private": NonPrivateExecutor,
    "ghost": FusedExecutor,
    "fastgradclip": FusedExecutor,
    "mixed_ghost": FusedExecutor,
    "bk_mixed": FusedExecutor,
}


def dp_value_and_clipped_grad(
    loss_with_ctx: LossFn, cfg: ClipConfig = ClipConfig()
) -> ClipExecutor:
    """Returns fn(params, batch, policy_state=None) -> (mean_loss,
    clipped_grad_sum, aux); ``clipped_grad_sum`` is sum_i C_i g_i."""
    if cfg.mode in LATER_MODES:
        raise NotImplementedError(
            f"clipping mode {cfg.mode!r} is ported with a later slice; have {MODES}"
        )
    try:
        executor_cls = _EXECUTORS[cfg.mode]
    except KeyError:
        raise ValueError(f"unknown clipping mode {cfg.mode!r}; have {MODES}") from None
    return executor_cls(loss_with_ctx, cfg)
