"""Plain PyTorch attention forward (port of ``kernels/flash_attention/ops.py``'s
serving path).

``flash_attention`` is the plain version of the CUDA kernel in
``flash_attention.py`` and of the Pallas kernel it replaces: softmax
attention in fp32 with grouped KV heads (query head ``h`` reads KV head
``h // (H / K)``), masked by position.  Two forms:

- the static form (``kv_positions=None``, an int ``q_offset``): query row
  ``i`` sits at ``q_offset + i``, key ``j`` at ``j``; causal and window
  masks as the kernel applies them;
- the serving form: ``kv_positions`` (B, Skv) gives each cache slot's
  absolute position per lane (-1 = empty, never attended) and ``q_offset``
  may be a (B,) tensor of per-lane fill levels.  This is the batched
  counterpart of ``_flash_fwd_impl(..., kv_positions=)`` under the JAX
  engine's ``vmap``; like the JAX package's XLA path it has no kernel.

Masked scores take the Pallas kernel's finite ``NEG_INF`` and the sum is
floored at 1e-30 before the division, so rows come out as the kernel's.
One case differs: a row with no reachable key averages every masked value
here, where the kernel, which skips dead tiles, averages those of its live
tiles only.  Neither the serving path nor the tests form such rows.
Which of the kernel and this version runs is decided by
``repro_torch.kernels.dispatch``.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

NEG_INF = -1e30  # the Pallas kernel's finite mask value (flash_attention.py:24)


def _mask(
    qpos: torch.Tensor, kpos: torch.Tensor, *, causal: bool, window: Optional[int],
    empty: bool,
) -> torch.Tensor:
    """(B, Sq, Skv) mask (True = attend) from absolute positions qpos (B, Sq)
    and kpos (B, Skv); ``empty`` masks the slots holding a negative position."""
    qi, kj = qpos[:, :, None], kpos[:, None, :]
    mask = torch.ones(qi.shape[0], qi.shape[1], kj.shape[2], dtype=torch.bool,
                      device=qpos.device)
    if causal:
        mask &= kj <= qi
    if window is not None:
        mask &= (qi - kj) < window
    if empty:
        mask &= kj >= 0
    return mask


def flash_attention(
    q: torch.Tensor,  # (B, Sq, H, hd)
    k: torch.Tensor,  # (B, Skv, K, hd)
    v: torch.Tensor,  # (B, Skv, K, hd)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: Union[int, torch.Tensor] = 0,
    kv_positions: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Attention forward in fp32; returns (B, Sq, H, hd) in q's dtype."""
    b, sq, h, hd = q.shape
    skv, kh = k.shape[1], k.shape[2]
    if h % kh:
        raise ValueError(f"{h} query heads are not a multiple of {kh} KV heads")
    dev = q.device
    offset = torch.as_tensor(q_offset, device=dev).reshape(-1, 1)  # (B or 1, 1)
    qpos = (offset + torch.arange(sq, device=dev)).expand(b, sq)
    if kv_positions is None:
        kpos = torch.arange(skv, device=dev).expand(b, skv)
    else:
        kpos = kv_positions.to(dev).expand(b, skv)
    mask = _mask(qpos, kpos, causal=causal, window=window, empty=kv_positions is not None)

    qf = q.float().reshape(b, sq, kh, h // kh, hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float()) * hd**-0.5
    scores = scores.masked_fill(~mask[:, None, None], NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    out = out / denom.permute(0, 3, 1, 2, 4)  # (B, Sq, K, g, 1)
    return out.reshape(b, sq, h, hd).to(q.dtype)
