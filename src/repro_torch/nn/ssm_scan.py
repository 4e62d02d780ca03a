"""Chunked linear-recurrence scan (port of ``nn/ssm_scan.py``).

Per head, the gated linear recurrence

    S_t = a_t * S_{t-1} + k_t v_t^T          (S: (dk, dv), a_t in (0, 1])
    y_t = q_t @ S_t

of the Mamba (SSD, scalar decay per head) and mLSTM blocks.  The sequence
runs in chunks of length L: within a chunk the contribution is a masked,
decay-weighted score matrix (quadratic in L only); across chunks one
(B, H, dk, dv) state is carried.  Where the JAX package scans the chunks
with ``lax.scan``, this is a Python loop over them, in plain PyTorch: the
JAX package has no kernel here, and the matrix products go to cuBLAS.

Numerics, the JAX package's:

- T is padded with zeros to a multiple of the chunk (a zero decay log
  keeps the state; zero k and v add nothing), and the padding is cut from y;
- q, k and v are sliced per chunk in their storage dtype and upcast there,
  never copied to fp32 whole (a copy the whole scan would hold: at Jamba's
  width each of q, k, v is (B, T, 256, 64) broadcast or projected); q and
  k may be broadcast views (Mamba's B and C are shared by every head), and
  only a chunk's slice is materialised;
- the state is fp32 (fp64 under fp64 compute, as the decay logs), and
  every exponent is of a non-positive sum (decay
  logs are <= 0): exp(cum_t) and exp(total - cum_s) by construction, and
  the within-chunk exp(cum_t - cum_s) only where s <= t: the entries above
  the diagonal are set to -inf before the exponent, so they are 0 and
  their gradient is 0 (the JAX package takes the exponent of every entry
  and masks after, which computes the same values wherever no entry
  overflows).

No input is written in place, so the scan runs under ``torch.func.vmap``
(the vmap oracle).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.nn.module import at_least_fp32


def _pad_time(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Zeros appended on dim 1 (time)."""
    if not pad:
        return x
    return F.pad(x, (0, 0) * (x.ndim - 2) + (0, pad))


def chunked_ssm(
    q: torch.Tensor,  # (B, T, H, dk)
    k: torch.Tensor,  # (B, T, H, dk)
    v: torch.Tensor,  # (B, T, H, dv)
    log_a: torch.Tensor,  # (B, T, H) decay logs, <= 0
    *,
    chunk: int = 256,
    state0: Optional[torch.Tensor] = None,  # (B, H, dk, dv) fp32
) -> tuple[torch.Tensor, torch.Tensor]:
    """(y (B, T, H, dv) in v's dtype, final state (B, H, dk, dv) fp32, or in
    the decay logs' dtype where that is wider)."""
    b, t, h, dk = q.shape
    dv = v.shape[-1]
    chunk = min(chunk, t)
    pad = (-t) % chunk
    q, k, v, log_a = (_pad_time(x, pad) for x in (q, k, v, log_a))
    la = at_least_fp32(log_a)
    state = (torch.zeros((b, h, dk, dv), dtype=la.dtype, device=q.device)
             if state0 is None else state0.to(la.dtype))
    causal = torch.ones((chunk, chunk), dtype=torch.bool, device=q.device).tril()
    ys = []
    for lo in range(0, t + pad, chunk):
        qc, kc, vc = (x[:, lo:lo + chunk].to(la.dtype) for x in (q, k, v))  # (B, L, H, .)
        cum = torch.cumsum(la[:, lo:lo + chunk], dim=1)  # (B, L, H) inclusive
        total = cum[:, -1]  # (B, H)
        # inter-chunk: y_t += exp(cum_t) q_t @ S0
        y_inter = torch.einsum("blhk,bhkv->blhv", qc * torch.exp(cum)[..., None], state)
        # intra-chunk: M[t, s] = (q_t . k_s) exp(cum_t - cum_s), s <= t
        scores = torch.einsum("blhk,bshk->bhls", qc, kc)
        decay = (cum[:, :, None, :] - cum[:, None, :, :]).permute(0, 3, 1, 2)  # (B, H, L, S)
        w = torch.exp(decay.masked_fill(~causal, float("-inf")))
        y_intra = torch.einsum("bhls,bshv->blhv", scores * w, vc)
        # state: S' = exp(total) S0 + sum_s exp(total - cum_s) k_s v_s^T
        kw = kc * torch.exp(total[:, None] - cum)[..., None]
        state = state * torch.exp(total)[..., None, None] + torch.einsum(
            "bshk,bshv->bhkv", kw, vc)
        ys.append(y_inter + y_intra)
    y = torch.cat(ys, dim=1)[:, :t]
    return y.to(v.dtype), state


def ssm_decode_step(
    q: torch.Tensor,  # (B, 1, H, dk)
    k: torch.Tensor,
    v: torch.Tensor,  # (B, 1, H, dv)
    log_a: torch.Tensor,  # (B, 1, H)
    state: torch.Tensor,  # (B, H, dk, dv) fp32
) -> tuple[torch.Tensor, torch.Tensor]:
    """One token's recurrent update (serving): (y (B, 1, H, dv), new state)."""
    a = torch.exp(log_a.float())[:, 0, :, None, None]  # (B, H, 1, 1)
    kv = torch.einsum("bhk,bhv->bhkv", k[:, 0].float(), v[:, 0].float())
    new_state = state * a + kv
    y = torch.einsum("bhk,bhkv->bhv", q[:, 0].float(), new_state)
    return y[:, None].to(v.dtype), new_state


def ssm_reference(q, k, v, log_a, state0=None) -> tuple[torch.Tensor, torch.Tensor]:
    """The sequential definition, one step at a time (the tests' oracle)."""
    b, t, h, dk = q.shape
    dv = v.shape[-1]
    s = (torch.zeros((b, h, dk, dv), dtype=torch.float32, device=q.device)
         if state0 is None else state0.float())
    ys = []
    for i in range(t):
        s = s * torch.exp(log_a[:, i].float())[..., None, None] + torch.einsum(
            "bhk,bhv->bhkv", k[:, i].float(), v[:, i].float())
        ys.append(torch.einsum("bhk,bhkv->bhv", q[:, i].float(), s))
    return torch.stack(ys, dim=1).to(v.dtype), s
