"""Per-layer-group clipping (port of ``policies/per_layer.py``).

One threshold per *group* of parameters instead of one global R: group
``g`` clips its own slice of each per-sample gradient to ``R_g``.  Groups
are param-path prefixes (longest match wins; a ``""`` catch-all is
appended so every leaf belongs to exactly one group), and
``R_g = R * sqrt(w_g / sum(w))``, so ``sum_g R_g^2 = R^2``: one sample's
clipped contribution stays within R and the noise calibration is the
global-R one.

Cost per executor family: book-keeping contracts each tap against its own
group's factors (the grouped ``psg_contract`` launch takes one factor row
per segment); the vmap oracle scales each leaf; the second-backward modes
run one backward per group.  A tap's weight and bias share one per-sample
norm, so a group boundary must not split them (the executors check).

State: ``{"step": int32, "thresholds": (G,) float32}`` on the step's device.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from repro_torch.core.functions import get_clip_fn
from repro_torch.policies.base import ClipPolicy, GroupedFactors, group_index


class PerLayerPolicy(ClipPolicy):
    name = "per_layer"
    grouped = True

    def __init__(
        self,
        groups: Sequence[str] = (),
        clip_norm: float = 1.0,
        clip_fn: str = "abadi",
        weights: Optional[Sequence[float]] = None,
    ):
        gs = tuple(str(g) for g in groups)
        if "" not in gs:
            gs = gs + ("",)  # catch-all: every leaf belongs somewhere
        if len(set(gs)) != len(gs):
            raise ValueError(f"duplicate layer-group prefixes in {gs!r}")
        self.groups = gs
        self.clip_norm = float(clip_norm)
        self.clip_fn_name = clip_fn
        self._clip_fn = get_clip_fn(clip_fn)
        if weights is None:
            w = [1.0] * len(gs)
        else:
            w = [float(x) for x in weights]
            if len(w) != len(gs) or any(x <= 0 for x in w):
                raise ValueError(
                    f"need one positive weight per group ({len(gs)} incl. the "
                    f"catch-all), got {weights!r}"
                )
        z = math.sqrt(sum(w))
        self._thresholds0 = tuple(self.clip_norm * math.sqrt(x) / z for x in w)

    def init_state(self, device: Optional[torch.device] = None) -> dict[str, torch.Tensor]:
        return {
            "step": torch.zeros((), dtype=torch.int32, device=device),
            "thresholds": torch.tensor(self._thresholds0, dtype=torch.float32, device=device),
        }

    def group_of(self, path: str) -> int:
        return group_index(self.groups, path)

    def clip_factors(
        self,
        norms: torch.Tensor,
        state: dict[str, torch.Tensor],
        *,
        path_norms2: Optional[dict[str, torch.Tensor]] = None,
    ) -> GroupedFactors:
        if path_norms2 is None:
            raise ValueError(
                "per_layer policy needs per-path norm contributions; the "
                "executor must hand it path_norms2"
            )
        g_norms2 = [torch.zeros_like(norms, dtype=torch.float32) for _ in self.groups]
        for path, n2 in sorted(path_norms2.items()):
            gi = self.group_of(path)
            g_norms2[gi] = g_norms2[gi] + n2.float()
        th = state["thresholds"]
        factors = torch.stack([
            self._clip_fn(torch.sqrt(n2), th[gi]) for gi, n2 in enumerate(g_norms2)
        ])
        return GroupedFactors(groups=self.groups, factors=factors)

    def sensitivity(self, state: dict[str, torch.Tensor]) -> torch.Tensor:
        # sqrt(sum R_g^2): clip_norm for the built-in splits; reading the
        # state keeps restored custom thresholds honest
        return torch.sqrt(torch.sum(state["thresholds"].square()))

    def fingerprint(self) -> str:
        th = ",".join(f"{t:g}" for t in self._thresholds0)
        return (
            f"per_layer:groups={'|'.join(self.groups)},R={self.clip_norm:g},"
            f"th={th},fn={self.clip_fn_name}"
        )
