"""Fixed-threshold policy: the paper's flat R (port of ``policies/fixed.py``)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.functions import get_clip_fn
from repro_torch.policies.base import ClipPolicy


class FixedPolicy(ClipPolicy):
    name = "fixed"

    def __init__(self, clip_norm: float = 1.0, clip_fn: str = "abadi"):
        self.clip_norm = float(clip_norm)
        self.clip_fn_name = clip_fn
        self._clip_fn = get_clip_fn(clip_fn)

    def clip_factors(
        self,
        norms: torch.Tensor,
        state: dict[str, torch.Tensor],
        *,
        path_norms2: Optional[dict[str, torch.Tensor]] = None,
    ) -> torch.Tensor:
        del state, path_norms2
        return self._clip_fn(norms, self.clip_norm)

    def sensitivity(self, state: dict[str, torch.Tensor]) -> float:
        del state
        return self.clip_norm

    def fingerprint(self) -> str:
        return f"fixed:R={self.clip_norm:g},fn={self.clip_fn_name}"
