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


def vocab_parallel_xent(
    logits: torch.Tensor,  # (B, S, V / n): this rank's vocabulary columns
    labels: torch.Tensor,  # (B, S) int, global ids; -100 = ignore
    sample_mask: Optional[torch.Tensor],  # (B,)
    group,
) -> torch.Tensor:
    """``per_sample_xent`` of logits split over the model axis by vocabulary
    (Megatron's vocab-parallel cross-entropy): the logits are never
    gathered; the max and the sum of exponentials are all-reduced, and the
    target logit is picked where this rank holds it, then all-reduced.  The
    same (B,) loss on every rank."""
    from repro_torch.parallel import collectives

    dist = torch.distributed
    cols = logits.shape[-1]
    valid = labels >= 0
    local = torch.where(valid, labels, torch.zeros_like(labels)).long() \
        - dist.get_rank(group) * cols
    mine = (local >= 0) & (local < cols)
    lf = logits.to(torch.promote_types(logits.dtype, torch.float32))
    m = collectives.all_reduce(lf.detach().amax(dim=-1), group, op="max")  # (B, S)
    sum_exp = collectives.reduce_from_model(torch.exp(lf - m[..., None]).sum(dim=-1), group)
    lse = torch.log(sum_exp) + m
    picked = torch.gather(lf, -1, torch.where(mine, local, torch.zeros_like(local))[..., None])
    picked = collectives.reduce_from_model(picked[..., 0] * mine.to(lf.dtype), group)
    tok_loss = (lse - picked) * valid.float()
    denom = valid.sum(dim=-1).clamp(min=1).float()
    loss = tok_loss.sum(dim=-1) / denom
    if sample_mask is not None:
        loss = loss * sample_mask.to(loss.dtype)
    return loss
