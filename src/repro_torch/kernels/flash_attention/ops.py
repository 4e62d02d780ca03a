"""Plain PyTorch attention (port of ``kernels/flash_attention/ops.py``): the
serving forward, and the blocked training attention with its own backward.

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

``flash_attention_train`` is the training attention, the JAX package's
``flash_attention`` with its custom VJP (``_flash`` / ``_flash_fwd_impl`` /
``_flash_bwd``): blocked online softmax over (block_q, block_kv) tiles that
never forms the (Sq, Skv) scores, fp32 inside, the result in q's dtype; the
residuals are q, k, v and the output in their own dtype and the fp32
log-sum-exp, and the backward recomputes each tile's probabilities.  Sq and
Skv are padded to the blocks as the JAX entry point pads them, padded keys
masked.  The JAX package runs it outside any Pallas kernel, so it has no
CUDA kernel here either.  Tiles that every mask kills are skipped: they
add exactly nothing to a row that has one live key, which every causal or
windowed row of a self-attention has (a dead tile before the first live one
is wiped by ``alpha = 0`` in the reference), so the values are the
reference's.  It is a ``torch.autograd.Function`` with ``setup_context``
and ``generate_vmap_rule``, so the ``vmap`` oracle (``torch.func``) runs
through it, and a retained graph runs its backward twice (the
second-backward modes).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch
import torch.nn.functional as F

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




@dataclasses.dataclass(frozen=True)
class _Tiling:
    """The static masks and tiles of one training-attention call: queries
    and keys both from position 0, ``kv_valid`` keys real (the rest
    padding; None: all)."""

    causal: bool
    window: Optional[int]
    bq: int
    bkv: int
    scale: float
    kv_valid: Optional[int]

    def live(self, i: int, j: int) -> bool:
        """Whether tile (query block i, key block j) holds one pair that no
        mask kills."""
        qlo, klo = i * self.bq, j * self.bkv
        if self.causal and klo > qlo + self.bq - 1:
            return False
        if self.window is not None and qlo - (klo + self.bkv - 1) >= self.window:
            return False
        return self.kv_valid is None or klo < self.kv_valid

    def mask(self, i: int, j: int, g: int, device) -> Optional[torch.Tensor]:
        """(bq * g, bkv) mask of tile (i, j) (True = attend; rows
        query-major, the g query heads of a KV head minor), or None where
        no mask bites."""
        bq, bkv = self.bq, self.bkv
        qlo, klo = i * bq, j * bkv
        causal = self.causal and klo + bkv - 1 > qlo
        window = self.window is not None and qlo + bq - 1 - klo >= self.window
        pad = self.kv_valid is not None and klo + bkv > self.kv_valid
        if not (causal or window or pad):
            return None
        qi = torch.arange(qlo, qlo + bq, device=device)[:, None]
        kj = torch.arange(klo, klo + bkv, device=device)[None, :]
        m = torch.ones((bq, bkv), dtype=torch.bool, device=device)
        if causal:
            m &= kj <= qi
        if window:
            m &= (qi - kj) < self.window
        if pad:
            m &= kj < self.kv_valid
        return m[:, None, :].expand(bq, g, bkv).reshape(bq * g, bkv)


def _rows(q: torch.Tensor, kh: int) -> torch.Tensor:
    """(B, S, H, hd) -> fp32 (B, K, S * g, hd): a query block's rows, the g
    heads of a KV head beside each position, are one contiguous slice."""
    b, s, h, hd = q.shape
    return q.float().reshape(b, s, kh, h // kh, hd).transpose(1, 2).reshape(b, kh, -1, hd)


def _unrows(x: torch.Tensor, h: int) -> torch.Tensor:
    """(B, K, S * g, hd) -> (B, S, H, hd)."""
    b, kh, n, hd = x.shape
    g = h // kh
    return x.reshape(b, kh, n // g, g, hd).transpose(1, 2).reshape(b, n // g, h, hd)


def _scores(q_i, k_j, tiling: _Tiling, i: int, j: int, g: int):
    s = torch.matmul(q_i, k_j.transpose(-1, -2)) * tiling.scale
    mask = tiling.mask(i, j, g, q_i.device)
    return s if mask is None else s.masked_fill(~mask, NEG_INF)


def _flash_fwd(q, k, v, tiling: _Tiling):
    """(out (B,Sq,H,hd) in q's dtype, lse (B,K,Sq*g) fp32)."""
    h = q.shape[2]
    kh = k.shape[2]
    g = h // kh
    bq, bkv = tiling.bq, tiling.bkv
    qr = _rows(q, kh)
    kf, vf = k.float().transpose(1, 2), v.float().transpose(1, 2)  # (B, K, Skv, hd)
    outs, lses = [], []
    for i in range(q.shape[1] // bq):
        q_i = qr[:, :, i * bq * g:(i + 1) * bq * g]
        o = qr.new_zeros(q_i.shape)
        m = qr.new_full(q_i.shape[:-1], NEG_INF)
        l = qr.new_zeros(q_i.shape[:-1])
        for j in range(k.shape[1] // bkv):
            if not tiling.live(i, j):
                continue
            s = _scores(q_i, kf[:, :, j * bkv:(j + 1) * bkv], tiling, i, j, g)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            o = o * alpha[..., None] + torch.matmul(p, vf[:, :, j * bkv:(j + 1) * bkv])
            m = m_new
        l = l.clamp_min(1e-30)
        outs.append(o / l[..., None])
        lses.append(m + torch.log(l))
    return _unrows(torch.cat(outs, dim=2), h).to(q.dtype), torch.cat(lses, dim=2)


def _flash_bwd(q, k, v, out, lse, dout, tiling: _Tiling):
    b, sq, h, hd = q.shape
    kh = k.shape[2]
    g = h // kh
    bq, bkv = tiling.bq, tiling.bkv
    nkv = k.shape[1] // bkv
    qr, dor = _rows(q, kh), _rows(dout, kh)
    kf, vf = k.float().transpose(1, 2), v.float().transpose(1, 2)
    delta = (dor * _rows(out, kh)).sum(dim=-1)  # (B, K, Sq * g)
    dqs = []
    dks: list = [None] * nkv
    dvs: list = [None] * nkv
    for i in range(sq // bq):
        rows = slice(i * bq * g, (i + 1) * bq * g)
        q_i, do_i = qr[:, :, rows], dor[:, :, rows]
        dq_i = torch.zeros_like(q_i)
        for j in range(nkv):
            if not tiling.live(i, j):
                continue
            k_j, v_j = kf[:, :, j * bkv:(j + 1) * bkv], vf[:, :, j * bkv:(j + 1) * bkv]
            p = torch.exp(_scores(q_i, k_j, tiling, i, j, g) - lse[:, :, rows, None])
            dp = torch.matmul(do_i, v_j.transpose(-1, -2))
            ds = p * (dp - delta[:, :, rows, None]) * tiling.scale
            dq_i = dq_i + torch.matmul(ds, k_j)
            dk_j = torch.matmul(ds.transpose(-1, -2), q_i)
            dv_j = torch.matmul(p.transpose(-1, -2), do_i)
            dks[j] = dk_j if dks[j] is None else dks[j] + dk_j
            dvs[j] = dv_j if dvs[j] is None else dvs[j] + dv_j
        dqs.append(dq_i)
    zero = kf.new_zeros((b, kh, bkv, hd))
    dk = torch.cat([zero if x is None else x for x in dks], dim=2).transpose(1, 2)
    dv = torch.cat([zero if x is None else x for x in dvs], dim=2).transpose(1, 2)
    return (_unrows(torch.cat(dqs, dim=2), h).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))


class _FlashAttention(torch.autograd.Function):
    """Blocked attention whose backward recomputes each tile (the JAX
    package's ``jax.custom_vjp`` around ``_flash``)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(q, k, v, tiling):
        return _flash_fwd(q, k, v, tiling)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, tiling = inputs
        out, lse = output
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mark_non_differentiable(lse)
        ctx.tiling = tiling

    @staticmethod
    def backward(ctx, dout, dlse):  # noqa: ARG004 - lse is not differentiable
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q, k, v, out, lse, dout, ctx.tiling)
        return dq, dk, dv, None


def flash_attention_train(
    q: torch.Tensor,  # (B, S, H, hd)
    k: torch.Tensor,  # (B, S, K, hd)
    v: torch.Tensor,  # (B, S, K, hd)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    block_q: int = 512,
    block_kv: int = 512,
) -> torch.Tensor:
    """Differentiable self-attention, (B, S, H, hd) in q's dtype (the JAX
    package's public ``flash_attention`` on its training path)."""
    sq, h, hd = q.shape[1:]
    skv, kh = k.shape[1], k.shape[2]
    if h % kh:
        raise ValueError(f"{h} query heads are not a multiple of {kh} KV heads")
    bq, bkv = min(block_q, max(sq, 1)), min(block_kv, max(skv, 1))
    pad_q, pad_kv = -sq % bq, -skv % bkv
    if pad_q:
        q = F.pad(q, (0, 0, 0, 0, 0, pad_q))
    if pad_kv:
        k = F.pad(k, (0, 0, 0, 0, 0, pad_kv))
        v = F.pad(v, (0, 0, 0, 0, 0, pad_kv))
    tiling = _Tiling(causal, window, bq, bkv, hd**-0.5, skv if pad_kv else None)
    out, _ = _FlashAttention.apply(q, k, v, tiling)
    return out[:, :sq] if pad_q else out
