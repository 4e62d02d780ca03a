"""The ClipPolicy protocol: how per-sample norms become clip factors
(port of ``policies/base.py``).

    init_state()                     -> dict of tensors (at least a step counter)
    clip_factors(norms, state)       -> (B,) factors
    update(state, norms, ...)        -> (new_state, PrivacyEvent), once per logical batch
    release_event()                  -> the static per-step privacy bill of ``update``
    sensitivity(state)               -> L2 bound on one sample's clipped contribution
    fingerprint()                    -> stable string identity

Grouped (per-layer) factors arrive with the ``per_layer`` policy.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch


@dataclasses.dataclass(frozen=True)
class PrivacyEvent:
    """Static description of one policy update's side release (sensitivity-1
    query with noise multiplier ``release_sigma``; ``None`` spends nothing)."""

    release_sigma: Optional[float] = None

    @property
    def spends(self) -> bool:
        return self.release_sigma is not None and self.release_sigma > 0


NO_RELEASE = PrivacyEvent()


class ClipPolicy:
    """Base class: the defaults every policy inherits or overrides."""

    name: str = "abstract"

    def init_state(self) -> dict[str, torch.Tensor]:
        return {"step": torch.zeros((), dtype=torch.int32)}

    def clip_factors(self, norms: torch.Tensor, state: dict[str, torch.Tensor]) -> torch.Tensor:
        raise NotImplementedError

    def update(
        self,
        state: dict[str, torch.Tensor],
        norms: torch.Tensor,
        *,
        generator: Optional[torch.Generator] = None,
        mask: Optional[torch.Tensor] = None,
    ) -> tuple[dict[str, torch.Tensor], PrivacyEvent]:
        """Default: data-free no-op (step counter only)."""
        del norms, generator, mask
        return {**state, "step": state["step"] + 1}, NO_RELEASE

    def release_event(self) -> PrivacyEvent:
        return NO_RELEASE

    def sensitivity(self, state: dict[str, torch.Tensor]) -> Any:
        raise NotImplementedError

    def fingerprint(self) -> str:
        raise NotImplementedError

    def __repr__(self) -> str:
        return f"<ClipPolicy {self.fingerprint()}>"
