"""Automatic (normalization) clipping, Bu et al., arXiv:2206.07136 (port of
``policies/automatic.py``).

AUTO-S: ``C_i = 1 / (||g_i|| + gamma)``; ``gamma = 0`` is AUTO-V (pure
normalization).  R merges into the learning rate and is fixed at 1, so the
sensitivity is ``||g_i|| / (||g_i|| + gamma) <= 1``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.policies.base import ClipPolicy


class AutomaticPolicy(ClipPolicy):
    name = "automatic"

    def __init__(self, gamma: float = 0.01):
        if gamma < 0:
            raise ValueError(f"gamma must be >= 0, got {gamma}")
        self.gamma = float(gamma)

    def clip_factors(
        self,
        norms: torch.Tensor,
        state: dict[str, torch.Tensor],
        *,
        path_norms2: Optional[dict[str, torch.Tensor]] = None,
    ) -> torch.Tensor:
        del state, path_norms2
        # AUTO-V (gamma == 0) guards the division; AUTO-S is smooth already
        denom = norms + self.gamma if self.gamma > 0 else torch.clamp(norms, min=1e-12)
        return 1.0 / denom

    def sensitivity(self, state: dict[str, torch.Tensor]) -> float:
        del state
        return 1.0

    def fingerprint(self) -> str:
        return f"automatic:gamma={self.gamma:g}"
