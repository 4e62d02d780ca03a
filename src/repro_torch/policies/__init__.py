"""repro_torch.policies: clipping policies on the ClipExecutor pipeline
(port of ``policies/__init__.py``).

- ``fixed``      the paper's flat R (the default)
- ``automatic``  AUTO-S/AUTO-V normalization (arXiv:2206.07136), no R
- ``quantile``   DP-adaptive R tracking a target norm quantile, paying for
                 its noised indicator release in the accountant
- ``per_layer``  per-param-prefix-group thresholds with sum R_g^2 = R^2

Select with ``make_policy(name, **kwargs)`` (kwargs filtered per policy) or
construct directly; ``ClipConfig.policy``, ``DPTrainConfig.policy`` and
``PrivacyEngine(clip_policy=)`` thread a policy end to end.
"""
from __future__ import annotations

import inspect
from typing import Any

from repro_torch.policies.automatic import AutomaticPolicy
from repro_torch.policies.base import (
    NO_RELEASE,
    ClipPolicy,
    GroupedFactors,
    PrivacyEvent,
    group_index,
)
from repro_torch.policies.fixed import FixedPolicy
from repro_torch.policies.per_layer import PerLayerPolicy
from repro_torch.policies.quantile import QuantilePolicy

POLICIES: dict[str, type] = {
    "fixed": FixedPolicy,
    "automatic": AutomaticPolicy,
    "quantile": QuantilePolicy,
    "per_layer": PerLayerPolicy,
}


def make_policy(name: str, **kwargs: Any) -> ClipPolicy:
    """Build a policy by name, keeping only the kwargs its __init__ takes
    (one call site can hold the union of every policy's knobs)."""
    try:
        cls = POLICIES[name]
    except KeyError:
        raise ValueError(f"unknown clip policy {name!r}; have {sorted(POLICIES)}") from None
    accepted = set(inspect.signature(cls.__init__).parameters) - {"self"}
    return cls(**{k: v for k, v in kwargs.items() if k in accepted})


__all__ = [
    "ClipPolicy", "PrivacyEvent", "NO_RELEASE", "GroupedFactors", "group_index",
    "FixedPolicy", "AutomaticPolicy", "QuantilePolicy", "PerLayerPolicy",
    "POLICIES", "make_policy",
]
