"""The paper's complexity model (Tables 1-2) and layerwise decision (Eq 4.1).

A copy of ``repro.core.decision`` (pure Python over ``TapMeta``), kept here
so the port never imports the JAX package.  All quantities are per layer,
in elements.  B = batch, T = output positions, D = fan-in (d*kh*kw),
p = fan-out.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

from repro_torch.core.taps import TapMeta


@dataclasses.dataclass(frozen=True)
class ModuleCost:
    time: float
    space: float


def back_propagation(B, T, D, p) -> ModuleCost:
    # Table 1 col 1: 2BTD(2p+1) time; BTp + 2BTD + pD space.
    return ModuleCost(time=2 * B * T * D * (2 * p + 1), space=B * T * p + 2 * B * T * D + p * D)


def ghost_norm(B, T, D, p) -> ModuleCost:
    # Table 1 col 2: 2BT^2(D+p+1) - B time; B(2T^2+1) space.
    return ModuleCost(time=2 * B * T * T * (D + p + 1) - B, space=B * (2 * T * T + 1))


def grad_instantiation(B, T, D, p) -> ModuleCost:
    # Table 1 col 3: 2B(T+1)pD time; B(pD+1) space.
    return ModuleCost(time=2 * B * (T + 1) * p * D, space=B * (p * D + 1))


def weighted_grad(B, T, D, p) -> ModuleCost:
    # Table 1 col 4: 2BpD time; 0 space.
    return ModuleCost(time=2 * B * p * D, space=0.0)


def ghost_is_cheaper(T: int, D: int, p: int, *, by: str = "space") -> bool:
    """Eq (4.1): choose ghost norm over instantiation iff 2T^2 < pD.

    ``by="time"`` implements the speed-priority variant (Remark 4.1):
    ghost iff 2T^2(D+p+1) < 2(T+1)pD.
    """
    if by == "time":
        return 2 * T * T * (D + p + 1) < 2 * (T + 1) * p * D
    return 2 * T * T < p * D


def bk_bank_prefers_ghost(
    T: int, D: int, p: int, *, groups: int = 1, a_elems: Optional[int] = None
) -> bool:
    """Book-keeping branch rule: bank the (a, g) book only when it is
    strictly smaller than the per-sample gradients (plus ~2T^2 Gram tiles)."""
    book = (a_elems if a_elems is not None else groups * T * D) + groups * T * p
    return book + 2 * T * T < groups * D * p


def decide(
    meta: TapMeta,
    *,
    mode: str = "mixed_ghost",
    by: str = "space",
    override: Optional[str] = None,
) -> str:
    """Per-tap branch: 'ghost' | 'instantiate'.

    Non-matmul kinds have a forced branch (scale/bias instantiate,
    embeddings ghost).  ``override`` wins over the analytic rule in the
    mixed modes only.
    """
    if meta.kind == "embedding":
        return "ghost"
    if meta.kind != "matmul":
        return "instantiate"
    if mode in ("ghost",):
        return "ghost"
    if mode in ("instantiate", "fastgradclip"):
        return "instantiate"
    if mode in ("mixed_ghost", "bk_mixed"):
        if override is not None:
            if override not in ("ghost", "instantiate"):
                raise ValueError(f"invalid branch override {override!r}")
            return override
        if mode == "bk_mixed":
            # a tap whose activation the model axis splits (a row-parallel
            # input, the experts): the full G*T*D; a whole one (a conv's raw
            # input) as recorded
            a_elems = None
            whole_a = meta.local is None or (meta.local[0], meta.local[2]) == (meta.D,
                                                                                meta.n_groups)
            if meta.a_shape is not None and whole_a:
                rows = max(meta.n_stack * meta.batch_size, 1)
                a_elems = math.prod(meta.a_shape) // rows
            return "ghost" if bk_bank_prefers_ghost(
                meta.T, meta.D, meta.p,
                groups=max(meta.n_groups, 1), a_elems=a_elems,
            ) else "instantiate"
        return "ghost" if ghost_is_cheaper(meta.T, meta.D, meta.p, by=by) else "instantiate"
    raise ValueError(f"unknown clipping mode {mode!r}")


def algorithm_cost(
    metas: dict[str, TapMeta], mode: str, *, by: str = "space"
) -> dict[str, float]:
    """Table 2: total per-iteration time/space of a clipping algorithm,
    summing matmul taps (the paper's analysis covers linear/conv layers)."""
    time = 0.0
    space = 0.0
    peak_clip_space = 0.0
    for m in metas.values():
        if m.kind != "matmul":
            continue
        reps = m.n_stack * max(m.n_groups, 1)
        B, T, D, p = m.batch_size, m.T, m.D, m.p
        bp = back_propagation(B, T, D, p)
        if mode == "non_private":
            time += reps * 3 * bp.time / 2
            space += reps * bp.space
            continue
        if mode == "opacus":
            gi = grad_instantiation(B, T, D, p)
            wg = weighted_grad(B, T, D, p)
            time += reps * (3 * bp.time / 2 + gi.time + wg.time)
            space += reps * (bp.space + gi.space)
            continue
        branch = decide(m, mode=mode if mode != "fastgradclip" else "instantiate", by=by)
        mod = ghost_norm(B, T, D, p) if branch == "ghost" else grad_instantiation(B, T, D, p)
        if mode == "bk_mixed":
            if branch == "ghost":
                wg_time = 2 * B * T * D * p
                bank = B * T * (D + p)
            else:
                wg_time = weighted_grad(B, T, D, p).time
                bank = B * p * D
            time += reps * (3 * bp.time / 2 + mod.time + wg_time)
            space += reps * (bp.space + bank)
        else:
            time += reps * (3 * bp.time / 2 + mod.time + bp.time)
            space += reps * bp.space
            peak_clip_space = max(peak_clip_space, reps * mod.space)
    return {"time": time, "space": space + peak_clip_space}
