"""The ClipPolicy protocol: how per-sample norms become clip factors
(port of ``policies/base.py``).

    init_state(device)               -> dict of tensors on ``device`` (at
                                        least a step counter)
    clip_factors(norms, state, path_norms2=None)
                                     -> (B,) factors, or GroupedFactors for
                                        per-layer-group policies
    update(state, norms, ...)        -> (new_state, PrivacyEvent), once per logical batch
    release_event()                  -> the static per-step privacy bill of ``update``
    sensitivity(state)               -> L2 bound on one sample's clipped contribution
    fingerprint()                    -> stable string identity

``grouped`` policies receive ``path_norms2``, each parameter path's squared
norm contribution (B,), instead of one norm per sample.  A policy's state
lives on the step's device, so neither ``clip_factors`` nor ``update``
waits for the device.  Where the JAX package takes an rng ``key``, the port
takes an explicit ``torch.Generator``.
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


def group_index(groups: tuple[str, ...], path: str) -> int:
    """Longest-prefix match of a param path against the group prefixes.

    ``""`` is the catch-all (matches every path); grouped policies append it
    so every leaf belongs to exactly one group.
    """
    best, best_len = -1, -1
    for i, prefix in enumerate(groups):
        if path.startswith(prefix) and len(prefix) > best_len:
            best, best_len = i, len(prefix)
    if best < 0:
        raise ValueError(
            f"param path {path!r} matches no layer group in {groups!r} "
            "(add a '' catch-all prefix)"
        )
    return best


@dataclasses.dataclass
class GroupedFactors:
    """Per-layer-group clip factors: one (B,) row per group.

    The gradient stages take them per param path (``for_path``): the
    book-keeping engines contract each tap's bank against its own group's
    row, the second-backward engines run one backward per group, and the
    vmap oracle scales each leaf's per-sample gradients.  ``representative``
    is the per-sample factor reported in aux (the smallest across groups).
    """

    groups: tuple[str, ...]  # prefixes, aligned with the rows of factors
    factors: torch.Tensor  # (G, B)

    def group_index(self, path: str) -> int:
        return group_index(self.groups, path)

    def for_path(self, path: str) -> torch.Tensor:
        return self.factors[self.group_index(path)]

    @property
    def representative(self) -> torch.Tensor:
        return self.factors.min(dim=0).values


class ClipPolicy:
    """Base class: the defaults every policy inherits or overrides."""

    name: str = "abstract"
    grouped: bool = False

    def init_state(self, device: Optional[torch.device] = None) -> dict[str, torch.Tensor]:
        return {"step": torch.zeros((), dtype=torch.int32, device=device)}

    def clip_factors(
        self,
        norms: torch.Tensor,
        state: dict[str, torch.Tensor],
        *,
        path_norms2: Optional[dict[str, torch.Tensor]] = None,
    ) -> Any:
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
