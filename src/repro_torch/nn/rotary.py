"""Rotary position embeddings (port of ``nn/rotary.py``).

Pairs are *interleaved*, as in the JAX package: feature ``2i`` and
``2i + 1`` rotate together by ``pos * theta^(-2i/hd)``.  This is not the
``rotate_half`` layout (first half against second half) common in
PyTorch code; the two give different values for the same weights.
"""
from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float = 10000.0, device=None) -> torch.Tensor:
    """(head_dim/2,) inverse frequencies in fp32."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta**exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """x (B, S, H, hd); positions (S,) or (B, S).  fp32 math, x's dtype out."""
    hd = x.shape[-1]
    inv = rope_freqs(hd, theta, device=x.device)
    pos = positions.to(device=x.device, dtype=torch.float32)
    if pos.ndim == 1:
        pos = pos[None, :]
    ang = pos[..., None] * inv  # (B, S, hd/2)
    cos = torch.cos(ang)[:, :, None, :]  # (B, S, 1, hd/2)
    sin = torch.sin(ang)[:, :, None, :]
    x1 = x[..., 0::2].float()
    x2 = x[..., 1::2].float()
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(x.shape).to(x.dtype)
