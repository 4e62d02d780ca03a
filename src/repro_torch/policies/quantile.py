"""DP quantile-adaptive clipping, Andrew et al. 2021 (arXiv:1905.03871)
(port of ``policies/quantile.py``).

Each logical step releases the noised fraction of samples whose norm fell
below the current threshold and moves the threshold geometrically toward
the target quantile ``q``::

    b_t     = (sum_i mask_i * I[||g_i|| <= R_t] + sigma_b * N(0, 1)) / B
    R_{t+1} = R_t * exp(-lr * (b_t - q))

The indicator count has sensitivity 1, so the release is a subsampled
Gaussian mechanism with noise multiplier ``sigma_b``, composed into the
accountant once per step (``PrivacyEvent(release_sigma=sigma_b)``).  The
denominator B is the static batch size, never the (private) mask sum.
``release_sigma = 0`` spends nothing and is NOT differentially private.

State ``{"step": int32, "clip_norm": float32}`` on the step's device; the
release draws its normal from the ``torch.Generator`` it is given (the
train state's), and raises without one.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.functions import get_clip_fn
from repro_torch.policies.base import NO_RELEASE, ClipPolicy, PrivacyEvent


class QuantilePolicy(ClipPolicy):
    name = "quantile"

    def __init__(
        self,
        target_quantile: float = 0.5,
        lr: float = 0.2,
        release_sigma: float = 1.0,
        init_clip_norm: float = 1.0,
        clip_fn: str = "abadi",
    ):
        if not 0.0 < target_quantile < 1.0:
            raise ValueError(f"target_quantile must be in (0, 1), got {target_quantile}")
        if release_sigma < 0:
            raise ValueError(f"release_sigma must be >= 0, got {release_sigma}")
        self.target_quantile = float(target_quantile)
        self.lr = float(lr)
        self.release_sigma = float(release_sigma)
        self.init_clip_norm = float(init_clip_norm)
        self.clip_fn_name = clip_fn
        self._clip_fn = get_clip_fn(clip_fn)

    def init_state(self, device: Optional[torch.device] = None) -> dict[str, torch.Tensor]:
        return {
            "step": torch.zeros((), dtype=torch.int32, device=device),
            "clip_norm": torch.tensor(self.init_clip_norm, dtype=torch.float32, device=device),
        }

    def clip_factors(
        self,
        norms: torch.Tensor,
        state: dict[str, torch.Tensor],
        *,
        path_norms2: Optional[dict[str, torch.Tensor]] = None,
    ) -> torch.Tensor:
        del path_norms2
        return self._clip_fn(norms, state["clip_norm"])

    def update(
        self,
        state: dict[str, torch.Tensor],
        norms: torch.Tensor,
        *,
        generator: Optional[torch.Generator] = None,
        mask: Optional[torch.Tensor] = None,
    ) -> tuple[dict[str, torch.Tensor], PrivacyEvent]:
        r = state["clip_norm"]
        below = (norms.float() <= r).float()
        if mask is not None:
            below = below * mask.float()
        count = below.sum()
        if self.release_sigma > 0:
            if generator is None:
                raise ValueError(
                    "quantile policy with release_sigma > 0 needs a generator "
                    "for the noised indicator release"
                )
            z = torch.randn((), generator=generator, device=generator.device)
            count = count + self.release_sigma * z
        # the denominator must be data-independent: the static batch size
        b_t = count / norms.shape[0]
        new_r = r * torch.exp(-self.lr * (b_t - self.target_quantile))
        return {"step": state["step"] + 1, "clip_norm": new_r}, self.release_event()

    def release_event(self) -> PrivacyEvent:
        if self.release_sigma > 0:
            return PrivacyEvent(release_sigma=self.release_sigma)
        return NO_RELEASE

    def sensitivity(self, state: dict[str, torch.Tensor]) -> torch.Tensor:
        return state["clip_norm"]

    def fingerprint(self) -> str:
        return (
            f"quantile:q={self.target_quantile:g},lr={self.lr:g},"
            f"sigma={self.release_sigma:g},R0={self.init_clip_norm:g},"
            f"fn={self.clip_fn_name}"
        )
