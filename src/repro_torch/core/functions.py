"""Clipping functions C(||g_i||; R) — any map bounded by R/||g_i|| (Eq. 2.1)."""
from __future__ import annotations

import torch


def abadi_clip(norms: torch.Tensor, clip_norm: float) -> torch.Tensor:
    """min(R/||g||, 1) — Abadi et al. 2016."""
    return torch.clamp(clip_norm / torch.clamp(norms, min=1e-12), max=1.0)


def global_clip(norms: torch.Tensor, clip_norm: float, z: float = 1.0) -> torch.Tensor:
    """I(||g|| < Z) * R/Z — Bu et al. 2021 (global clipping)."""
    return torch.where(norms < z, clip_norm / z, 0.0).to(norms.dtype)


def automatic_clip(norms: torch.Tensor, clip_norm: float, gamma: float = 0.01) -> torch.Tensor:
    """R/(||g|| + gamma) — automatic (normalized) clipping, Bu et al. 2022."""
    return clip_norm / (norms + gamma)


CLIP_FUNCTIONS = {
    "abadi": abadi_clip,
    "global": global_clip,
    "automatic": automatic_clip,
}


def get_clip_fn(name: str):
    try:
        return CLIP_FUNCTIONS[name]
    except KeyError:
        raise ValueError(
            f"unknown clip function {name!r}; have {list(CLIP_FUNCTIONS)}"
        ) from None
