"""Per-sample losses (the DP unit of account is the sample, not the token)."""
from __future__ import annotations

from typing import Optional

import torch


def per_sample_xent(
    logits: torch.Tensor,  # (B, S, V)
    labels: torch.Tensor,  # (B, S) int; -100 = ignore
    sample_mask: Optional[torch.Tensor] = None,  # (B,)
) -> torch.Tensor:
    """Mean token cross-entropy per sample: (B,) in fp32, or fp64 for fp64
    logits."""
    valid = labels >= 0
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    lf = logits.to(torch.promote_types(logits.dtype, torch.float32))
    lse = torch.logsumexp(lf, dim=-1)  # (B, S)
    picked = torch.gather(lf, -1, safe[..., None])[..., 0]
    tok_loss = (lse - picked) * valid.float()
    denom = valid.sum(dim=-1).clamp(min=1).float()
    loss = tok_loss.sum(dim=-1) / denom
    if sample_mask is not None:
        loss = loss * sample_mask.to(loss.dtype)
    return loss
