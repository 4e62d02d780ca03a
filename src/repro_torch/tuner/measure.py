"""Measured per-tap branch costs: the three-way clipping decision (port of
``tuner/measure.py``).

The analytic decision (Eq 4.1) counts multiplies; this module times the
port's own branch code on the device, over synthetic data of each tap's
shape at ``max_rows`` rows, with ``warmup`` discarded calls and the median
of ``repeats`` (the host clock around calls that end in
``torch.cuda.synchronize()``, so the wrappers' host work counts: the port's
steps are partly host-bound).  Five timings per matmul tap:

- ``ghost_us`` / ``instantiate_us``: the norm branches as ``ghost.tap_norm_sq``
  runs them under a forced override (the second-backward modes pick the
  cheaper and then pay ``second_bwd_us`` on top);
- ``bk_ghost_us``: ghost norm + the book contraction from the (a, g) book
  (``ghost.tap_weighted_grads``, one ``book_weighted_grad`` launch);
- ``bk_instantiate_us``: the per-sample gradient bank (``ghost._matmul_psg``:
  a ``bmm`` for dense taps, ``_conv_psg``'s grouped convolution for convs)
  with its norm + the bank's contraction (``dispatch.psg_contract``);
- ``second_bwd_us``: the tap's dW and dX GEMMs, its share of the second
  backward that book-keeping skips.

Convolutions differ from the JAX package here.  The reference times both
conv norm branches on the unfolded patches, so the im2col cancels out of
its comparison.  In the port the ghost branch reads the raw NHWC input
(the kernel's conv entry never unfolds) while the instantiate branch
unfolds (``unfold2d``), and the ghost book unfolds for its contraction
while the psg bank does not: each timing includes the unfold its branch
pays, so the comparison prices it.

Kernel choice per tap.  The JAX package races the Pallas kernel against
XLA on a TPU.  The port has one production impl per device
(``dispatch.available_impls``: the CUDA kernel on the card, the plain
version on the CPU), recorded without a race, as the reference records XLA
off TPU; the plain versions are yardsticks on the card (``chip_smoke.py``
times kernel against plain and library) and never a plan's choice.  The
race below stays for a device with two production impls.

Only matmul taps get branch timings; embedding, scale and bias taps have a
forced branch (``decision.decide``) and are never overridden.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Mapping, Optional

import torch

from repro_torch.core import ghost
from repro_torch.core.decision import decide
from repro_torch.core.taps import TapMeta
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import dispatch
from repro_torch.tuner.plan import (
    ClipPlan,
    TapTiming,
    device_string,
    dtype_name,
    shape_fingerprint,
    tap_signature,
)

log = logging.getLogger("repro_torch.tuner.measure")


@dataclasses.dataclass(frozen=True)
class MeasureConfig:
    """Profiling knobs shared by every tuner measurement pass.

    Medians over ``repeats`` timed calls absorb scheduler noise, ``warmup``
    absorbs first-call costs (kernel builds, cuBLAS handles, the
    allocator), and ``max_rows`` clamps the profiled rows so a large-batch
    model is tuned without exhausting the device it is sizing (timings
    scale about linearly in rows, so the comparison survives).
    """

    repeats: int = 5
    warmup: int = 2
    ghost_block: int = 512
    inst_block_d: int = 8192
    max_rows: Optional[int] = 64  # None: the discovered batch as is
    seed: int = 0


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_us(fn, *args, repeats: int = 5, warmup: int = 2) -> float:
    """Median wall-clock microseconds per ``fn(*args)`` call.

    The device is synchronised before and after every timed call (the
    first tensor argument's device), so asynchronous launches cannot
    under-report; the first ``warmup`` calls are discarded.
    """
    device = next((x.device for x in args if isinstance(x, torch.Tensor)),
                  torch.device("cpu"))
    for _ in range(max(warmup, 1)):
        fn(*args)
    _sync(device)
    samples = []
    for _ in range(max(repeats, 1)):
        t0 = time.perf_counter()
        fn(*args)
        _sync(device)
        samples.append((time.perf_counter() - t0) * 1e6)
    samples.sort()
    return samples[len(samples) // 2]


def _tap_rows(meta: TapMeta, max_rows: Optional[int]) -> int:
    n = meta.n_stack * max(meta.batch_size, 1) * max(meta.n_groups, 1)
    if max_rows is not None:
        n = max(1, min(n, max_rows))
    return n


# dispatch ops with a measurable impl choice, per tap kind; scale and bias
# taps bank tiny per-sample gradients and keep the device default
KERNEL_OPS_BY_KIND = {
    "matmul": ("ghost_norm", "psg_contract"),
    "embedding": ("embedding_ghost_norm",),
}


def _one_layer(meta: TapMeta, n: int) -> TapMeta:
    """The tap as one unstacked layer at ``n`` samples (its shapes' trailing
    per-sample dims kept)."""
    lead = len(meta.stack_dims) + 1
    return dataclasses.replace(
        meta, batch_size=n, stack_dims=(),
        s_shape=(n,) + tuple(meta.s_shape[lead:]),
        a_shape=None if meta.a_shape is None else (n,) + tuple(meta.a_shape[lead:]),
    )


def _dtype(name_or_dtype) -> torch.dtype:
    return getattr(torch, dtype_name(name_or_dtype))


def _synthetic(meta: TapMeta, n: int, device: torch.device, seed: int):
    """(one-layer meta, a, g, c) for ``n`` rows: ``a`` as the tap records it
    (a conv's raw NHWC input, ids for an embedding), ``g`` the cotangent in
    the pre-activation's dtype, ``c`` clip factors."""
    m1 = _one_layer(meta, n)
    gen = torch.Generator(device=device).manual_seed(seed)
    s_dt = _dtype(meta.s_dtype)
    a_dt = _dtype(meta.a_dtype if meta.a_dtype is not None else meta.s_dtype)
    g = torch.randn(m1.s_shape, generator=gen, device=device).to(s_dt)
    if meta.kind == "embedding":
        a = torch.randint(0, max(meta.D, 1), (n, meta.T), generator=gen, device=device)
    else:
        a_shape = m1.a_shape if m1.a_shape is not None else (n, meta.T, meta.D)
        a = torch.randn(a_shape, generator=gen, device=device).to(a_dt)
    c = torch.rand(n, generator=gen, device=device)
    return m1, a, g, c


def measure_tap_kernels(
    meta: TapMeta, cfg: MeasureConfig = MeasureConfig(), device: DeviceLike = None
) -> dict[str, str]:
    """The impl per dispatch op for one tap: ``{op: impl}`` for every op in
    ``KERNEL_OPS_BY_KIND[kind]`` ({} for the other kinds).  With one
    production impl on the device (always, in the port) it is recorded
    without timing; with two, they are raced (outside ``force_impl``,
    which outranks the impl each side asks for)."""
    ops_ = KERNEL_OPS_BY_KIND.get(meta.kind, ())
    if not ops_:
        return {}
    dev = resolve_device(device)
    avail = dispatch.available_impls(dev)
    if len(avail) == 1:
        return {op: avail[0] for op in ops_}

    m1, a, g, c = _synthetic(meta, _tap_rows(meta, cfg.max_rows), dev, cfg.seed)
    shape = ghost.psg_param_shape(m1) if meta.kind == "matmul" else (meta.D, meta.p)
    out: dict[str, str] = {}

    def race(op: str, make_fn) -> None:
        per_impl = {impl: time_us(make_fn({op: impl}), a, g, c,
                                  repeats=cfg.repeats, warmup=cfg.warmup)
                    for impl in avail}
        winner = min(sorted(per_impl), key=per_impl.get)
        log.info("%s kernels: %s -> %s", op,
                 " ".join(f"{i}={t:.1f}us" for i, t in sorted(per_impl.items())), winner)
        out[op] = winner

    if meta.kind == "matmul":
        race("ghost_norm", lambda k: lambda x, y, cc: ghost.tap_norm_sq(
            m1, x, y, mode="ghost", ghost_block=cfg.ghost_block, kernels=k,
            include_bias=False))
        race("psg_contract", lambda k: lambda x, y, cc: ghost.tap_weighted_grads(
            dataclasses.replace(m1, bias_path=None), x, y, cc, shape, kernels=k))
    else:
        race("embedding_ghost_norm", lambda k: lambda x, y, cc: ghost.tap_norm_sq(
            m1, x, y, mode="mixed_ghost", kernels=k, include_bias=False))
    return out


def measure_tap(
    meta: TapMeta,
    cfg: MeasureConfig = MeasureConfig(),
    kernels: Optional[Mapping[str, str]] = None,
    device: DeviceLike = None,
) -> Optional[TapTiming]:
    """Time every branch of the three-way decision for one matmul tap on
    synthetic data of its shape (``None`` for the other kinds, whose branch
    is forced).  ``kernels`` pins the impl per dispatch op."""
    if meta.kind != "matmul":
        return None
    dev = resolve_device(device)
    n = _tap_rows(meta, cfg.max_rows)
    m1, a, g, c = _synthetic(meta, n, dev, cfg.seed)
    m1 = dataclasses.replace(m1, bias_path=None)  # the weight's branches only
    shape = ghost.psg_param_shape(m1)
    knobs = dict(ghost_block=cfg.ghost_block, inst_block_d=cfg.inst_block_d,
                 kernels=kernels, include_bias=False)
    k_psg = dispatch.kernels_arg(kernels, "psg_contract")

    def norm(branch):
        return lambda x, y: ghost.tap_norm_sq(m1, x, y, mode="mixed_ghost",
                                              override=branch, **knobs)

    def bk_ghost(x, y, cc):
        norms = ghost.tap_norm_sq(m1, x, y, mode="ghost", **knobs)
        return norms, ghost.tap_weighted_grads(m1, x, y, cc, shape, kernels=kernels)

    def bk_inst(x, y, cc):
        psg = ghost._matmul_psg(m1, x, y.float())
        norms = psg.square().reshape(n, -1).sum(dim=-1)
        return norms, dispatch.psg_contract(psg, cc, impl=k_psg)

    # the tap's share of the second backward: dW = a^T g, dX = g W^T
    if meta.conv is not None:
        from repro_torch.nn.conv import unfold2d

        a2 = unfold2d(a, meta.conv)
    else:
        a2 = a
    a2 = a2.reshape(-1, meta.D)
    w = torch.randn(meta.D, meta.p, device=dev).to(a2.dtype)

    def second_bwd(x, y, ww):
        yy = y.reshape(-1, meta.p).to(x.dtype)
        return x.t() @ yy, yy @ ww.t()

    r = dict(repeats=cfg.repeats, warmup=cfg.warmup)
    return TapTiming(
        ghost_us=time_us(norm("ghost"), a, g, **r),
        instantiate_us=time_us(norm("instantiate"), a, g, **r),
        bk_ghost_us=time_us(bk_ghost, a, g, c, **r),
        bk_instantiate_us=time_us(bk_inst, a, g, c, **r),
        second_bwd_us=time_us(second_bwd, a2, g, w, **r),
    )


def _shape_key(name: str, meta: TapMeta) -> tuple:
    sig = tap_signature(name, meta)
    del sig["name"]
    return tuple(sorted((k, tuple(v) if isinstance(v, list) else v)
                        for k, v in sig.items()))


def measure_kernels(
    metas: Mapping[str, TapMeta], cfg: MeasureConfig = MeasureConfig(),
    device: DeviceLike = None,
) -> dict[str, dict[str, str]]:
    """Per-tap impl choices, one measurement per unique shape signature
    (identically shaped layers run identical kernels)."""
    by_shape: dict[tuple, dict[str, str]] = {}
    out: dict[str, dict[str, str]] = {}
    for name in sorted(metas):
        meta = metas[name]
        if meta.kind not in KERNEL_OPS_BY_KIND:
            continue
        key = _shape_key(name, meta)
        if key not in by_shape:
            by_shape[key] = measure_tap_kernels(meta, cfg, device)
        if by_shape[key]:
            out[name] = by_shape[key]
    return out


def measure_branches(
    metas: Mapping[str, TapMeta],
    cfg: MeasureConfig = MeasureConfig(),
    kernels: Optional[Mapping[str, Mapping[str, str]]] = None,
    device: DeviceLike = None,
) -> dict[str, TapTiming]:
    """One timing per unique shape signature, fanned out to every tap of
    that shape: measuring identical layers apart would let timer noise pick
    different branches for them."""
    by_shape: dict[tuple, TapTiming] = {}
    out: dict[str, TapTiming] = {}
    for name in sorted(metas):
        meta = metas[name]
        if meta.kind != "matmul":
            continue
        key = _shape_key(name, meta)
        timing = by_shape.get(key)
        if timing is None:
            timing = measure_tap(meta, cfg, None if kernels is None else kernels.get(name),
                                 device)
            by_shape[key] = timing
            analytic = decide(meta, mode="mixed_ghost")
            mark = "" if analytic == timing.winner else f"  (!= analytic {analytic})"
            log.info(
                "%s: ghost=%.1fus inst=%.1fus bk_ghost=%.1fus bk_inst=%.1fus "
                "2nd_bwd=%.1fus -> %s/%s%s",
                name, timing.ghost_us, timing.instantiate_us, timing.bk_ghost_us,
                timing.bk_instantiate_us, timing.second_bwd_us, timing.winner,
                timing.bk_winner, mark,
            )
        out[name] = timing
    return out


def _plan_fields(timings: Mapping[str, TapTiming]) -> dict:
    return dict(
        branches=tuple((name, t.winner) for name, t in sorted(timings.items())),
        bk_branches=tuple((name, t.bk_winner) for name, t in sorted(timings.items())),
        timings=tuple(t.as_tuple(name) for name, t in sorted(timings.items())),
    )


def _kernel_rows(kernels: Mapping[str, Mapping[str, str]]) -> tuple[tuple[str, str, str], ...]:
    """Flatten {tap: {op: impl}} to the sorted triples ClipPlan stores."""
    return tuple((name, op, impl) for name in sorted(kernels)
                 for op, impl in sorted(kernels[name].items()))


def build_plan(
    metas: Mapping[str, TapMeta],
    *,
    measure: MeasureConfig = MeasureConfig(),
    arch: Optional[str] = None,
    device: DeviceLike = None,
) -> ClipPlan:
    """Profile every matmul tap on ``device`` (None: the GPU) and assemble
    the measured-cost ClipPlan: the impls first, then the branch timings
    under them."""
    kernels = measure_kernels(metas, measure, device)
    timings = measure_branches(metas, measure, kernels=kernels, device=device)
    return ClipPlan(
        fingerprint=shape_fingerprint(metas),
        device=device_string(device),
        arch=arch,
        kernels=_kernel_rows(kernels),
        **_plan_fields(timings),
    )


def remeasure_at_batch(
    plan: ClipPlan,
    metas: Mapping[str, TapMeta],
    physical_batch: int,
    cfg: MeasureConfig = MeasureConfig(),
    *,
    cap_bytes: int = 1 << 30,
    device: DeviceLike = None,
) -> ClipPlan:
    """Re-time the branches at the tuned physical batch and refresh the plan.

    The first timings are taken at the row-clamped probe batch; once the
    max-batch search settles, the step runs at ``physical_batch``, so the
    branches are timed there (the fingerprint is batch-free: the refreshed
    plan stays valid).  ``cap_bytes`` bounds each tap's largest profiling
    set (a, g and a psg bank live at once): a tap that would exceed it is
    timed at the largest batch that fits.  The impls are chosen again at
    the new shapes and land in the plan with the timings.
    """
    rebatched, clamped = {}, 0
    for name, m in metas.items():
        b = physical_batch
        if m.kind == "matmul":
            reps = max(m.n_stack * max(m.n_groups, 1), 1)
            per_row = 4 * (m.T * m.D + m.T * m.p + m.D * m.p)
            b_cap = max(1, cap_bytes // max(per_row * reps, 1))
            if b_cap < b:
                b, clamped = b_cap, clamped + 1
        rebatched[name] = dataclasses.replace(m, batch_size=b)
    if clamped:
        log.info("remeasure: %d tap(s) clamped below physical batch %d to respect the "
                 "%.1f GB profiling cap", clamped, physical_batch, cap_bytes / 1024**3)
    cfg_full = dataclasses.replace(cfg, max_rows=None)
    kernels = measure_kernels(rebatched, cfg_full, device)
    old_kernels = plan.kernel_map()
    kernel_flips = sum(1 for name, ops in kernels.items() for op, impl in ops.items()
                       if old_kernels.get(name, {}).get(op, impl) != impl)
    if kernel_flips:
        log.info("re-choosing impls at physical batch %d changed %d", physical_batch,
                 kernel_flips)
    timings = measure_branches(rebatched, cfg_full, kernels=kernels, device=device)
    flips = sum(1 for name, b in plan.branches
                if timings.get(name) and timings[name].winner != b)
    flips += sum(1 for name, b in plan.bk_branches
                 if timings.get(name) and timings[name].bk_winner != b)
    if flips:
        log.info("re-measuring at physical batch %d flipped %d branch(es)", physical_batch,
                 flips)
    return dataclasses.replace(plan, measured_at_physical=True, kernels=_kernel_rows(kernels),
                               **_plan_fields(timings))


def close_physical_batch_loop(
    plan: ClipPlan,
    metas: Mapping[str, TapMeta],
    search,  # (plan) -> max physical batch under the caller's budget, <= 0: none
    logical_batch: int,
    budget_bytes: int,
    cfg: MeasureConfig = MeasureConfig(),
    *,
    max_iters: int = 3,
    device: DeviceLike = None,
) -> ClipPlan:
    """Converge {branch maps, physical batch} to a consistent pair.

    The branches are measured at the batch that will run, and a flipped
    branch changes the tap's clipping memory, which can move the largest
    batch that fits: re-measure and re-search alternate until neither
    moves (``max_iters`` bounds an oscillation).  On a failed re-search the
    last certified plan is returned.
    """
    from repro_torch.tuner.max_batch import derive_accumulation

    mp = plan.physical_batch
    if not mp or mp <= 0:
        return plan
    for _ in range(max_iters):
        certified = plan
        plan = remeasure_at_batch(plan, metas, mp, cfg, device=device)
        if (plan.branches, plan.bk_branches) == (certified.branches, certified.bk_branches):
            return plan  # branches stable at the certified batch
        mp2 = search(plan)
        if mp2 <= 0:
            log.warning("re-measured branches no longer fit the budget at batch %d; "
                        "keeping the certified plan", mp)
            return certified
        if mp2 == mp:
            return plan  # the flips did not move the certificate
        log.info("branch flips moved the max physical batch %d -> %d; re-measuring there",
                 mp, mp2)
        _, steps = derive_accumulation(logical_batch, mp2)
        plan = dataclasses.replace(
            plan.replace_batch(physical_batch=mp2, logical_batch=logical_batch,
                               accumulation_steps=steps, budget_bytes=budget_bytes),
            measured_at_physical=False,  # timings are still from mp
        )
        mp = mp2
    log.warning("branch/batch loop did not converge in %d rounds; timings were last "
                "taken one batch behind", max_iters)
    return plan
