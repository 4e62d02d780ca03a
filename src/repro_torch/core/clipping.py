"""Per-sample gradient clipping engines (port of ``core/clipping.py``).

The model exposes ``loss_with_ctx(params, batch, ctx) -> per_sample_losses``;
everything else happens here.  Every mode is a ``ClipExecutor``, one
three-stage pipeline

    norms stage    -> per-sample squared norms (mode-specific machinery)
    factor stage   -> C_i = policy(||g_i||) * mask         (the ClipPolicy)
    gradient stage -> sum_i C_i g_i                         (mode-specific)

Modes:

- ``vmap``  the Opacus analogue and the correctness oracle: per-sample
  gradients from ``torch.func.vmap`` of ``torch.func.grad_and_value`` of
  the single-sample loss (the forward under ``Ctx.disabled()``), clipped
  and summed; O(B x |params|) memory.
- ``ghost`` / ``fastgradclip`` / ``mixed_ghost``  the fused probes compute
  the norms inside the first backward (ghost norm everywhere / instantiation
  everywhere / the paper's Eq-(4.1) layerwise choice, Alg. 1), then a second
  backward over the same graph with the clip factors as the loss cotangent
  gives the clipped gradient sum: 1 forward + 2 backward.
- ``bk_mixed``  book-keeping (arXiv:2210.00038): the probes also bank the
  residuals, and the gradient stage contracts the banks with the clip
  factors; no second backward.
- ``*_taps``  the reference executors on the explicit-tap engine: every tap
  records its input and keeps its pre-activation ``s``; the first backward
  is taken with respect to the ``s`` tensors, the norms are computed per
  tap afterwards, then a second backward (``bk_mixed_taps``: a book
  contraction of every tap).  The exactness oracle for the fused engine.
- ``non_private``  C_i = 1, the baseline.

Grouped policies (``per_layer``) take ``path_norms2``, each parameter
path's squared-norm contribution, from every executor and give one factor
row per layer group: the second-backward modes run one backward per group
on the retained graph, book-keeping contracts each tap (and each psg bank,
in the one grouped launch) against its own group's row, vmap scales each
leaf.

Flow of the fused family (``FusedExecutor``)::

    losses = model(params, batch, ctx)              # probes record a per tap
    grad(losses, inputs=zs, grad_outputs=ones)      # 1st backward: banks only,
                                                    # param-grad kernels pruned
    C = policy(sqrt(sum_tap banks[tap]["n"])) * mask
    grad(losses, inputs=params, grad_outputs=C)     # 2nd backward (not bk_mixed)

A late tap (a recurrent weight, ``Ctx.record_act``) has no probe: the
first backward also takes dL/ds at its recorded pre-activation, in the
same ``torch.autograd.grad`` call, and its norm (and, in ``bk_mixed``, its
book contraction) comes from the explicit ``(a, g)`` as in the explicit
engine.  Its pre-activations leave ``zs`` right after that backward (a
checkpointed layer's recomputation closes over the ``Ctx``).

The tuner's knobs: ``decision_by`` (Eq. 4.1 by space or Remark 4.1 by
time), ``ghost_block`` and ``inst_block_d`` (the plain versions' tiles) and
``plan`` (a ``repro_torch.tuner.ClipPlan``, duck-typed: its per-tap branch
overrides for the running mode and its per-tap kernel choices).  The fused
and explicit executors read the plan once the forward has named the taps
and thread it to every tap, as the JAX package does.  A stale plan
(another device, another shape fingerprint) gives no override and no
kernel choice: the analytic rule and the device default apply, and the
plan logs why.  A kernel choice other than the device's production impl
(``dispatch.available_impls``: the kernel on the card) is refused, and a
``dispatch.force_impl`` override outranks every recorded choice.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Iterable, Optional

import torch

from repro_torch.core import ghost
from repro_torch.core.taps import ClipRuntime, Ctx, TapMeta, bank_keys
from repro_torch.kernels import dispatch
from repro_torch.parallel import reshard
from repro_torch.policies.base import GroupedFactors, group_index
from repro_torch.utils.tree import flatten_dict, tree_map, unflatten_dict

LossFn = Callable[..., torch.Tensor]  # (params, batch, ctx) -> (B,) losses

MODES = (
    "vmap", "ghost", "fastgradclip", "mixed_ghost", "bk_mixed",
    "ghost_taps", "fastgradclip_taps", "mixed_ghost_taps", "bk_mixed_taps",
    "non_private",
)


@dataclasses.dataclass(frozen=True)
class ClipConfig:
    mode: str = "mixed_ghost"
    clip_norm: float = 1.0
    clip_fn: str = "abadi"
    decision_by: str = "space"  # Eq 4.1 (space) or Remark 4.1 (time)
    ghost_block: int = 512
    inst_block_d: int = 8192
    # measured-cost branch plan (repro_torch.tuner.ClipPlan, duck-typed to
    # keep core free of tuner imports); a plan whose device or shape
    # fingerprint does not match the model gives the analytic rule
    plan: Optional[Any] = None
    # clipping policy (repro_torch.policies.ClipPolicy); None builds the
    # fixed flat-R policy from (clip_norm, clip_fn)
    policy: Optional[Any] = None


def _plan_overrides(
    plan: Optional[Any], meta: dict[str, TapMeta], mode: str, device: torch.device
) -> dict[str, str]:
    """Validated per-tap branch overrides from a tuner plan ({} if stale).

    Plans are mode-specific: the book-keeping branch trades bank size, not
    norm cost, so ``bk_mixed`` reads another branch map than
    ``mixed_ghost``; ``plan.overrides_for`` dispatches on the mode.
    """
    if plan is None:
        return {}
    return plan.overrides_for(meta, device=device, mode=mode)


def _plan_kernels(
    plan: Optional[Any], meta: dict[str, TapMeta], device: torch.device
) -> dict[str, dict[str, str]]:
    """Validated per-tap kernel choices from a tuner plan ({} if stale).

    ``{tap: {op: impl}}``; an impl other than the device's production one
    raises: no plan sends a card's tap to the plain version."""
    if plan is None:
        return {}
    fn = getattr(plan, "kernels_for", None)
    kernels = fn(meta, device=device) if fn is not None else {}
    allowed = dispatch.available_impls(device)
    for name, ops in kernels.items():
        for op, impl in ops.items():
            if impl not in allowed:
                raise ValueError(
                    f"plan routes tap {name!r}'s {op} to {impl!r} on {device}; "
                    f"this device runs {allowed}")
    return kernels


def _psg_impl(kernels: dict[str, dict[str, str]], names: Iterable[str]) -> Optional[str]:
    """The one impl of a step's grouped psg contraction: the taps' recorded
    choice (they must agree; one launch serves them all)."""
    choices = {kernels[n]["psg_contract"] for n in names
               if "psg_contract" in kernels.get(n, {})}
    if len(choices) > 1:
        raise ValueError(f"one grouped psg_contract launch, but the plan records {choices}")
    return choices.pop() if choices else None


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


def _param_grads(losses, leaves: dict[str, torch.Tensor], cotangent,
                 retain_graph: bool = False) -> dict[str, torch.Tensor]:
    """{path: grad of sum_i cotangent_i L_i} over ``leaves`` (zeros where unused)."""
    grads = torch.autograd.grad(
        losses, list(leaves.values()), grad_outputs=cotangent.to(losses.dtype),
        allow_unused=True, retain_graph=retain_graph,
    )
    return {k: torch.zeros_like(v) if gr is None else gr
            for (k, v), gr in zip(leaves.items(), grads)}


def _grouped_second_backward(st: "_NormState", c: GroupedFactors) -> Any:
    """Second-backward gradient stage under per-layer-group clip factors.

    The loss cotangent is one weight per sample, so factors that differ per
    layer group cannot ride one second backward: one backward per group,
    each over that group's leaves only, on the graph retained through all
    but the last.
    """
    by_group: dict[int, dict[str, torch.Tensor]] = {}
    for path, leaf in st.leaves.items():
        by_group.setdefault(c.group_index(path), {})[path] = leaf
    out: dict[str, torch.Tensor] = {}
    order = sorted(by_group)
    for i, gi in enumerate(order):
        out.update(_param_grads(st.losses, by_group[gi], c.factors[gi],
                                retain_graph=i < len(order) - 1))
    return unflatten_dict({path: out[path] for path in st.leaves})


def _assemble_bk_grads(params: Any, parts: Iterable[dict[str, torch.Tensor]]) -> Any:
    """Book-keeping gradient assembly: sum every part's {path: grad}, zero-fill
    the uncovered (frozen) leaves and cast back to each leaf's dtype."""
    flat_params = flatten_dict(params)
    flat_grads: dict[str, torch.Tensor] = {}
    for part in parts:
        for path, val in part.items():
            flat_grads[path] = flat_grads[path] + val if path in flat_grads else val
    return unflatten_dict({
        path: flat_grads[path].to(leaf.dtype) if path in flat_grads else torch.zeros_like(leaf)
        for path, leaf in flat_params.items()
    })


def _stacked(xs: list[Optional[torch.Tensor]]) -> Optional[torch.Tensor]:
    """One tap's per-layer tensors on a leading stack dim (one layer: as is;
    a tap without an activation: None)."""
    if xs[0] is None:
        return None
    return xs[0] if len(xs) == 1 else torch.stack(xs)


def _first_backward(losses: torch.Tensor, zs: dict, retain_graph: bool) -> dict:
    """{key: dL/d zs[key]} of one backward with unit loss cotangents (zeros
    where a key does not reach the losses); ``zs`` is emptied after it: a
    pre-activation kept there would tie the step's graph to a checkpointed
    layer's recomputation, which closes over the ``Ctx``."""
    keys = list(zs)
    gs = torch.autograd.grad(
        losses, [zs[k] for k in keys], grad_outputs=torch.ones_like(losses),
        retain_graph=retain_graph, allow_unused=True,
    )
    out = {k: torch.zeros_like(zs[k]) if g is None else g for k, g in zip(keys, gs)}
    zs.clear()
    return out


@dataclasses.dataclass
class _NormState:
    """What the norms stage hands the gradient stage (one step's plumbing)."""

    losses: torch.Tensor
    norms2: torch.Tensor
    leaves: Optional[dict[str, torch.Tensor]] = None  # second-backward modes
    runtime: Optional[ClipRuntime] = None  # the probes' phase flag and banks
    meta: Optional[dict[str, TapMeta]] = None
    acts: Optional[dict[str, torch.Tensor]] = None  # explicit engine (fused: late taps)
    gs: Optional[dict[str, torch.Tensor]] = None  # dL/ds per tap, as ``acts``
    per_sample_grads: Optional[dict[str, torch.Tensor]] = None  # vmap only
    # grouped policies: {param_path: (B,)} squared-norm contributions,
    # summing to norms2
    path_norms2: Optional[dict[str, torch.Tensor]] = None
    # the sharded step: {param_path: full shape}, the leaves being shards
    shapes: Optional[dict[str, tuple]] = None
    # explicit engine: the plan's per-tap kernel choices, for the books
    kernels: Optional[dict[str, dict[str, str]]] = None


class ClipExecutor:
    """Template for every clipping mode: norms -> clip factors -> gradients.

    ``fn(params, batch, policy_state=None) -> (mean_loss, clipped_grad_sum,
    aux)`` with aux = {"per_sample_norms": (B,), "clip_factors": (B,)} (a
    grouped policy reports its smallest factor per sample).  Noise is added
    downstream by the privacy engine.

    The sharded step passes ``shapes`` ({path: full shape}), its
    ``params`` being this rank's shards: the book-keeping sums are built at
    the full shapes (the step reduce-scatters them), every other gradient
    at the stored leaf's.
    """

    def __init__(self, loss_with_ctx: LossFn, cfg: ClipConfig):
        self.loss = loss_with_ctx
        self.cfg = cfg
        if cfg.policy is not None:
            self.policy = cfg.policy
        else:
            from repro_torch.policies.fixed import FixedPolicy

            self.policy = FixedPolicy(clip_norm=cfg.clip_norm, clip_fn=cfg.clip_fn)
        self.grouped = bool(getattr(self.policy, "grouped", False))

    def _norm_state(self, params, batch) -> _NormState:
        raise NotImplementedError

    def _tally(self, per_tap: Iterable[tuple[TapMeta, torch.Tensor]], b: int,
               device: torch.device):
        """(norms2 (B,), path_norms2 or None) from each tap's (B,) norm."""
        norms2 = torch.zeros(b, dtype=torch.float32, device=device)
        path_norms2: Optional[dict[str, torch.Tensor]] = {} if self.grouped else None
        for m, n in per_tap:
            norms2 = norms2 + n
            if path_norms2 is not None:
                prev = path_norms2.get(m.param_path)
                path_norms2[m.param_path] = n if prev is None else prev + n
        return norms2, path_norms2

    def _explicit_norm(self, name: str, m: TapMeta, a, g, mode: str, overrides: dict,
                       kernels: dict) -> torch.Tensor:
        """Tap ``name``'s (B,) norm from its explicit (a, g), on ``mode``'s branch."""
        cfg = self.cfg
        return ghost.tap_norm_sq(
            m, a, g, mode=mode, decision_by=cfg.decision_by, ghost_block=cfg.ghost_block,
            inst_block_d=cfg.inst_block_d, override=overrides.get(name),
            kernels=kernels.get(name))

    @staticmethod
    def _shape(st: "_NormState", path: str, flat_params: dict[str, torch.Tensor]) -> tuple:
        """A leaf's full shape (its stored shape outside a sharded step)."""
        if st.shapes is not None:
            return tuple(st.shapes[path])
        return tuple(flat_params[path].shape)

    def _validate_groups(self, meta: dict[str, TapMeta]) -> None:
        """A group boundary must not split a tap's (weight, bias) pair: their
        per-sample norm is computed jointly."""
        for name, m in meta.items():
            if m.bias_path is None:
                continue
            groups = self.policy.groups
            if group_index(groups, m.param_path) != group_index(groups, m.bias_path):
                raise ValueError(
                    f"layer groups split tap {name!r}: weight {m.param_path!r} and bias "
                    f"{m.bias_path!r} land in different groups but share one per-sample norm"
                )

    def _clip_factors(self, norms, mask, st: _NormState, pstate):
        c = self.policy.clip_factors(norms, pstate, path_norms2=st.path_norms2)
        if isinstance(c, GroupedFactors):
            f = c.factors if mask is None else c.factors * mask.to(c.factors.dtype)[None, :]
            return dataclasses.replace(c, factors=f.detach())
        if mask is not None:
            c = c * mask.to(c.dtype)
        return c.detach()

    def _weighted_grads(self, st: _NormState, c, params) -> Any:
        raise NotImplementedError

    def __call__(self, params, batch, policy_state=None, *, shapes=None):
        mask = _batch_mask(batch)
        st = self._norm_state(params, batch)
        st.shapes = shapes
        norms = torch.sqrt(st.norms2)
        pstate = (policy_state if policy_state is not None
                  else self.policy.init_state(device=norms.device))
        c = self._clip_factors(norms, mask, st, pstate)
        grads = self._weighted_grads(st, c, params)
        loss = st.losses.detach().sum() / st.losses.shape[0]
        rep = c.representative if isinstance(c, GroupedFactors) else c
        return loss, grads, {"per_sample_norms": norms, "clip_factors": rep}


class VmapUnderShardingError(NotImplementedError):
    """The ``vmap`` oracle under a data axis of more than one rank:
    ``torch.func``'s transforms cannot issue the weight gathers."""


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

    def _clip_factors(self, norms, mask, st, pstate):
        return torch.ones_like(norms)

    def _weighted_grads(self, st, c, params):
        return unflatten_dict(_param_grads(st.losses, st.leaves, c))


class VmapExecutor(ClipExecutor):
    """Opacus analogue and correctness oracle: vmap(grad) per sample.

    Each sample gets a singleton batch dim (``x[:, None]``) and runs the
    forward under ``Ctx.disabled()``, so no tap, probe or kernel is on its
    path.  Keeps the per-sample gradients (B x |params| floats); the
    per-path norms are exact, so grouped policies need nothing more.
    """

    _groups_checked = False

    def _norm_state(self, params, batch) -> _NormState:
        from torch.func import grad_and_value, vmap

        if reshard.data_size() > 1:
            raise VmapUnderShardingError(
                "the vmap oracle cannot issue collectives: run it on one rank "
                f"(the data axis has {reshard.data_size()})")

        def single(p, ex):
            # torch.func refuses checkpointing's saved-tensor hooks: no remat
            return self.loss(p, ex, Ctx.disabled(remat=False))[0]

        per_ex = tree_map(lambda x: x[:, None], batch)
        grads, losses = vmap(grad_and_value(single), in_dims=(None, 0))(params, per_ex)
        flat = flatten_dict(grads)
        if self.grouped and not self._groups_checked:
            # a group boundary through a tap's (weight, bias) pair would give
            # this oracle semantics no other executor reproduces; the taps
            # are the model's, so one traced forward checks them for good
            self._validate_groups(discover_meta(self.loss, params, batch))
            self._groups_checked = True
        b = losses.shape[0]
        per_path = {path: g.float().reshape(b, -1).square().sum(dim=-1)
                    for path, g in flat.items()}
        return _NormState(
            losses=losses, norms2=sum(per_path.values()), per_sample_grads=flat,
            path_norms2=per_path if self.grouped else None,
        )

    def _weighted_grads(self, st, c, params):
        grouped = isinstance(c, GroupedFactors)
        return unflatten_dict({
            path: torch.tensordot(c.for_path(path) if grouped else c, g.float(),
                                  dims=([0], [0])).to(g.dtype)
            for path, g in st.per_sample_grads.items()
        })


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
        runtime = ClipRuntime(mode=cfg.mode, decision_by=cfg.decision_by,
                              ghost_block=cfg.ghost_block, inst_block_d=cfg.inst_block_d)
        leaves = None
        if not self.is_bk:
            leaves, params = _leaves_requiring_grad(params)
        ctx = Ctx(meta={}, clip=runtime)
        losses = self.loss(params, batch, ctx)
        # the forward has named the taps: the plan's choices for the probes
        runtime.overrides = _plan_overrides(cfg.plan, ctx.meta, cfg.mode, losses.device)
        runtime.kernels = _plan_kernels(cfg.plan, ctx.meta, losses.device)
        # first backward: gradients of the probes' dummy leaves (and of the
        # late taps' pre-activations) only, so autograd runs every probe and
        # prunes every parameter-gradient kernel
        cot = _first_backward(losses, ctx.zs, retain_graph=not self.is_bk)
        runtime.phase = "grad"
        if self.grouped:
            self._validate_groups(ctx.meta)
        acts, gs, per_tap = {}, {}, []
        for name, m in ctx.meta.items():
            keys = bank_keys(name, m)
            if not m.late:
                per_tap.append((m, sum(runtime.banks[k]["n"] for k in keys)))  # over layers
                continue
            acts[name] = _stacked([ctx.late_acts[k] for k in keys])
            gs[name] = _stacked([cot[k] for k in keys])
            per_tap.append((m, self._explicit_norm(name, m, acts[name], gs[name], cfg.mode,
                                                   runtime.overrides, runtime.kernels)))
        norms2, path_norms2 = self._tally(per_tap, losses.shape[0], losses.device)
        if not self.is_bk:  # the second backward needs no late activation
            acts = gs = {}
        return _NormState(
            losses=losses.detach() if self.is_bk else losses,
            norms2=norms2, leaves=leaves, runtime=runtime, meta=ctx.meta,
            path_norms2=path_norms2, acts=acts, gs=gs,
        )

    def _weighted_grads(self, st, c, params):
        grouped = isinstance(c, GroupedFactors)
        if not self.is_bk:
            if grouped:
                return _grouped_second_backward(st, c)
            return unflatten_dict(_param_grads(st.losses, st.leaves, c))  # second backward
        # book-keeping: contractions of the banks; nothing re-propagates.
        # A book contracts per tap against its group's factors; every psg
        # bank of the step contracts in one grouped call, each against its
        # own group's row, its sums written to the parameter paths after
        flat_params = flatten_dict(params)
        kernels = st.runtime.kernels
        parts, segments, psg_taps = [], [], []
        for name, m in st.meta.items():
            shape = self._shape(st, m.param_path, flat_params)
            if m.late:  # the explicit channel: a book contraction
                cw = c.for_path(m.param_path) if grouped else c
                parts.append(ghost.tap_weighted_grads(m, st.acts[name], st.gs[name], cw, shape,
                                                      kernels=kernels.get(name)))
                continue
            banks = [st.runtime.banks.pop(k) for k in bank_keys(name, m)]
            if "g" in banks[0]:
                book = _stack_banks(banks)
                cw = c.for_path(m.param_path) if grouped else c
                parts.append(ghost.tap_weighted_grads(m, book["a"], book["g"], cw, shape,
                                                      kernels=kernels.get(name)))
            else:
                segments.extend(ghost.psg_segments(m, banks, shape))
                psg_taps.append(name)
        if segments:
            psgs = [x for _, _, xs in segments for x in xs]
            impl = _psg_impl(kernels, psg_taps)
            if grouped:
                rows = [c.group_index(path) for path, _, xs in segments for _ in xs]
                sums = dispatch.psg_contract_grouped(psgs, c.factors, rows, impl=impl)
            else:
                sums = dispatch.psg_contract_grouped(psgs, c, impl=impl)
            at, part = 0, {}
            for path, shape, _ in segments:
                size = math.prod(shape)
                part[path] = sums[at:at + size].reshape(shape)
                at += size
            parts.append(part)
        return _assemble_bk_grads(params, parts)


def _stack_banks(banks: list[dict[str, torch.Tensor]]) -> dict[str, torch.Tensor]:
    """One tap's per-layer (a, g) books, stacked in layer order (the norm
    ``n`` is already summed by the norms stage)."""
    if len(banks) == 1:
        return banks[0]
    return {k: torch.stack([bk[k] for bk in banks]) for k in banks[0] if k != "n"}


class TapsExecutor(ClipExecutor):
    """Reference explicit-tap engine (``*_taps`` modes).

    The forward records every tap's input and pre-activation (``Ctx`` with
    ``acts``).  The first backward is taken with respect to the
    pre-activations only, which gives each tap's ``dL/ds`` and prunes every
    parameter-gradient kernel; ``tap_norm_sq`` then norms each tap (a
    stacked tap once, its layers stacked on a leading dim) on the branch its
    mode picks.  The gradient stage is a second backward over the retained
    graph, or for ``bk_mixed_taps`` a book contraction of every tap
    (``ghost.tap_weighted_grads``).  It keeps every activation and
    cotangent of the step: the transparent formulation the fused engine is
    tested against.  Under a rematerialised stack the pre-activations leave
    ``zs`` once the first backward has read them: a checkpointed layer's
    recomputation closes over the ``Ctx``, so an ``s`` held there would tie
    the graph to itself, and a grouped policy's partial backwards leave
    saved tensors behind that would keep the step's graph alive.
    """

    def __init__(self, loss_with_ctx: LossFn, cfg: ClipConfig):
        super().__init__(loss_with_ctx, cfg)
        self.branch_mode = cfg.mode.removesuffix("_taps")

    @property
    def is_bk(self) -> bool:
        return self.branch_mode == "bk_mixed"

    def _norm_state(self, params, batch) -> _NormState:
        cfg = self.cfg
        leaves, p = _leaves_requiring_grad(params)
        ctx = Ctx(meta={}, acts={})
        losses = self.loss(p, batch, ctx)
        overrides = _plan_overrides(cfg.plan, ctx.meta, self.branch_mode, losses.device)
        kernels = _plan_kernels(cfg.plan, ctx.meta, losses.device)
        # first backward: dL/ds at every tap; the graph stays for the second
        # (zs emptied after it: no reference cycle through a recomputation)
        cot = _first_backward(losses, ctx.zs, retain_graph=not self.is_bk)
        if self.grouped:
            self._validate_groups(ctx.meta)
        acts, cots, per_tap = {}, {}, []
        for name, m in ctx.meta.items():
            ks = bank_keys(name, m)
            acts[name] = _stacked([ctx.acts[k] for k in ks])
            cots[name] = _stacked([cot[k] for k in ks])
            per_tap.append((m, self._explicit_norm(name, m, acts[name], cots[name],
                                                   self.branch_mode, overrides, kernels)))
        norms2, path_norms2 = self._tally(per_tap, losses.shape[0], losses.device)
        if not self.is_bk:  # the second backward needs no activation or cotangent
            return _NormState(losses=losses, norms2=norms2, leaves=leaves,
                              path_norms2=path_norms2)
        return _NormState(losses=losses.detach(), norms2=norms2, meta=ctx.meta, acts=acts,
                          gs=cots, path_norms2=path_norms2, kernels=kernels)

    def _weighted_grads(self, st, c, params):
        grouped = isinstance(c, GroupedFactors)
        if not self.is_bk:
            if grouped:
                return _grouped_second_backward(st, c)
            return unflatten_dict(_param_grads(st.losses, st.leaves, c))  # second backward
        flat_params = flatten_dict(params)
        return _assemble_bk_grads(params, (
            ghost.tap_weighted_grads(m, st.acts[name], st.gs[name],
                                     c.for_path(m.param_path) if grouped else c,
                                     self._shape(st, m.param_path, flat_params),
                                     kernels=st.kernels.get(name))
            for name, m in st.meta.items()
        ))


_EXECUTORS = {
    "non_private": NonPrivateExecutor,
    "vmap": VmapExecutor,
    "ghost": FusedExecutor,
    "fastgradclip": FusedExecutor,
    "mixed_ghost": FusedExecutor,
    "bk_mixed": FusedExecutor,
    "ghost_taps": TapsExecutor,
    "fastgradclip_taps": TapsExecutor,
    "mixed_ghost_taps": TapsExecutor,
    "bk_mixed_taps": TapsExecutor,
}


def dp_value_and_clipped_grad(
    loss_with_ctx: LossFn, cfg: ClipConfig = ClipConfig()
) -> ClipExecutor:
    """Returns fn(params, batch, policy_state=None) -> (mean_loss,
    clipped_grad_sum, aux); ``clipped_grad_sum`` is sum_i C_i g_i.  The
    policy's update runs outside (once per logical batch, ``launch.steps``)."""
    try:
        executor_cls = _EXECUTORS[cfg.mode]
    except KeyError:
        raise ValueError(f"unknown clipping mode {cfg.mode!r}; have {MODES}") from None
    return executor_cls(loss_with_ctx, cfg)
