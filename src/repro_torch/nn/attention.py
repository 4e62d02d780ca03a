"""Grouped-query attention with RoPE, causal and sliding-window masks, a
KV cache, cross-attention and the context-parallel decode (port of
``nn/attention.py``).

The projections are ``Dense`` modules, so each gets a DP tap; the
attention itself has no parameters and the clipping engine never sees it.

Without a cache (training) attention runs in fp32 outside any kernel, as
the JAX package computes it outside any Pallas kernel.  Causal, windowed or
grouped-head attention (the decoder LMs) and cross-attention go through
``flash_attention_train``, the JAX package's blocked attention with its
custom VJP (``block_q`` / ``block_kv`` from the configuration); the
bidirectional MHA of the ViT and of Whisper's encoder keeps the plain
softmax on fp32 copies of q, k and v (``attention``).  The JAX package
runs those through its blocked op too: the values agree to fp32 summation
order, and the plain form is a divergence by design (one matmul pair, no
tile loop).  Both run the same ops in every backward, so ``mixed_ghost``'s
second backward over the retained graph repeats the first's arithmetic.

With a cache (serving) the three branches of the JAX module:

- decode (``s == 1``): each lane writes its row at ``idx % length`` and
  attends over its cache with the plain serving form of
  ``dispatch.flash_attention`` (per-lane ``kv_positions`` and
  ``q_offset``), or, once the cache holds ``cp_threshold`` (65536) rows or
  more, with ``blocked_decode_attention`` over ``cp_blocks`` (64) blocks;
- prefill from an empty cache (``s <= length``): rows ``0..s-1`` are
  filled, and the prompt attends over its own K/V through the kernel
  (static causal / window masks, ``q_offset`` 0).  The JAX package sends
  this call through its XLA serving form over the whole cache, where the
  rows past the prompt hold position -1 and are masked: the same values,
  but there it never reaches the Pallas kernel.  The port routes it to the
  kernel on purpose, so that every prefill launches it;
- ring prefill (``s > length``, a window shorter than the cache): the
  prompt attends over all of its K/V through the kernel and the last
  ``length`` rows stay in the ring, slot ``j`` holding position ``p`` with
  ``p % length == j``.

Cross-attention (``cross=True``, Whisper's decoder): q comes from ``x``,
k and v from the encoder states ``kv_src`` (B, Skv, d), with no RoPE and
no mask.  Training runs ``flash_attention_train(causal=False)`` with
Sq != Skv.  In serving a prefill (``kv_src`` given) writes the k and v
projections into the block's ``xkv`` cache (B, enc_seq, K, hd) and a decode
step (``kv_src=None``) reads them; both attend through the static form of
``dispatch.flash_attention``, so every cross-attention call on the card,
prefill or decode, launches the kernel.

Divergences by design: the cache's ``pos`` (B, length) and ``idx`` (B,)
are per lane, where the JAX cache has one ``pos`` (length,) and a scalar
``idx`` under the engine's ``vmap``, so one batched decode serves lanes at
different fill levels; and a block writes its new rows into the cache it
is given, in place (the models hand it a copy).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.taps import Ctx
from repro_torch.kernels import dispatch
from repro_torch.kernels.flash_attention.ops import flash_attention_train
from repro_torch.nn.module import AxesTree, Dense, Module, Params
from repro_torch.nn.rotary import apply_rope


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Bidirectional softmax attention in fp32: q, k, v (B, S, H, hd) ->
    (B, S, H, hd) in q's dtype."""
    hd = q.shape[-1]
    qf, kf, vf = (x.float().transpose(1, 2) for x in (q, k, v))  # (B, H, S, hd)
    probs = torch.softmax(qf @ kf.transpose(-1, -2) * hd**-0.5, dim=-1)
    return (probs @ vf).transpose(1, 2).to(q.dtype)


def blocked_decode_attention(
    q: torch.Tensor,  # (B, 1, H, hd)
    k: torch.Tensor,  # (B, S, K, hd)
    v: torch.Tensor,  # (B, S, K, hd)
    pos: torch.Tensor,  # (B, S) absolute positions per lane, -1 = empty slot
    qpos: torch.Tensor,  # (B,) absolute position of each lane's query
    *,
    n_blocks: int,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Context-parallel decode: a partial softmax per block of S / n_blocks
    cache rows, then a small combine over the blocks; (B, 1, H, hd) in q's
    dtype.

    The JAX package shards the blocks over its model axis, so each block's
    (o, m, l) stays local and the combine is an all-reduce of (B, H, hd).
    On one card the blocks are a batch dim of the same einsums; it has no
    kernel in either package.  Slots at positions past the query's or
    empty are masked, as in the JAX function (whose ``causal`` flag it
    ignores: decode is causal by construction)."""
    b, _, h, hd = q.shape
    kh = k.shape[2]
    g = h // kh
    s_len = k.shape[1]
    if s_len % n_blocks:
        raise ValueError(f"cache length {s_len} is not a multiple of {n_blocks} blocks")
    blk = s_len // n_blocks

    qf = q.float().reshape(b, kh, g, hd)
    kb = k.float().reshape(b, n_blocks, blk, kh, hd)
    vb = v.float().reshape(b, n_blocks, blk, kh, hd)
    pb = pos.reshape(b, n_blocks, blk)
    qp = qpos.reshape(b, 1, 1)

    scores = torch.einsum("bkgd,bnskd->bnkgs", qf, kb) * hd**-0.5  # (B, nb, K, g, blk)
    mask = (pb <= qp) & (pb >= 0)
    if window is not None:
        mask &= (qp - pb) < window
    scores = scores.masked_fill(~mask[:, :, None, None, :], -1e30)

    m_b = scores.amax(dim=-1)  # (B, nb, K, g)
    p = torch.exp(scores - m_b[..., None])
    l_b = p.sum(dim=-1)
    o_b = torch.einsum("bnkgs,bnskd->bnkgd", p, vb)
    # combine across blocks (the JAX package's only cross-shard reduction)
    m = m_b.amax(dim=1, keepdim=True)
    w = torch.exp(m_b - m)
    l = (w * l_b).sum(dim=1)
    o = (w[..., None] * o_b).sum(dim=1) / l.clamp_min(1e-30)[..., None]
    return o.reshape(b, 1, h, hd).to(q.dtype)


def make_kv_cache(
    batch: int, max_len: int, n_kv: int, head_dim: int, dtype: torch.dtype, *,
    window: Optional[int] = None, device: torch.device,
) -> dict:
    """An empty KV cache: a ring of ``min(max_len, window)`` rows when a
    sliding window bounds the reachable context.  ``pos`` holds each row's
    absolute position per lane (-1 = empty), ``idx`` each lane's fill level."""
    length = min(max_len, window) if window else max_len
    return {
        "k": torch.zeros((batch, length, n_kv, head_dim), dtype=dtype, device=device),
        "v": torch.zeros((batch, length, n_kv, head_dim), dtype=dtype, device=device),
        "pos": torch.full((batch, length), -1, dtype=torch.long, device=device),
        "idx": torch.zeros((batch,), dtype=torch.long, device=device),
    }


class Attention(Module):
    def __init__(
        self, name: str, d_model: int, n_heads: int, n_kv: int, *,
        head_dim: Optional[int] = None, qkv_bias: bool = False, use_rope: bool = True,
        rope_theta: float = 10000.0, causal: bool = True, window: Optional[int] = None,
        cross: bool = False, block_q: int = 512, block_kv: int = 512,
        cp_threshold: int = 65536, cp_blocks: int = 64,
        dtype=torch.float32, param_dtype=torch.float32, device: torch.device,
    ):
        if n_heads % n_kv:
            raise ValueError(f"{name}: {n_heads} heads not a multiple of {n_kv} KV heads")
        self.name = name
        self.n_heads = n_heads
        self.n_kv = n_kv
        self.head_dim = head_dim or d_model // n_heads
        self.use_rope = use_rope
        self.rope_theta = rope_theta
        self.causal = causal
        self.window = window
        self.cross = cross
        self.block_q = block_q
        self.block_kv = block_kv
        self.cp_threshold = cp_threshold
        self.cp_blocks = cp_blocks
        common = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.wq = Dense(f"{name}.q", d_model, n_heads * self.head_dim, use_bias=qkv_bias,
                        w_axes=("embed", "heads"), **common)
        self.wk = Dense(f"{name}.k", d_model, n_kv * self.head_dim, use_bias=qkv_bias,
                        w_axes=("embed", "kv_heads"), **common)
        self.wv = Dense(f"{name}.v", d_model, n_kv * self.head_dim, use_bias=qkv_bias,
                        w_axes=("embed", "kv_heads"), **common)
        self.wo = Dense(f"{name}.o", n_heads * self.head_dim, d_model, use_bias=False,
                        w_axes=("heads", "embed"), **common)

    def init(self, generator: torch.Generator) -> Params:
        return {
            "q": self.wq.init(generator),
            "k": self.wk.init(generator),
            "v": self.wv.init(generator),
            "o": self.wo.init(generator),
        }

    def axes(self) -> AxesTree:
        return {"q": self.wq.axes(), "k": self.wk.axes(), "v": self.wv.axes(),
                "o": self.wo.axes()}

    def __call__(
        self, params: Params, x: torch.Tensor, ctx: Ctx, *,
        positions: Optional[torch.Tensor] = None,  # (S,) or (B, S)
        cache: Optional[dict] = None,
        kv_src: Optional[torch.Tensor] = None,  # (B, Skv, d) encoder states (cross)
    ):
        """Without ``cache`` returns y; with it, (y, cache) after writing the
        new rows into ``cache`` in place."""
        b, s, _ = x.shape
        q = self.wq(params["q"], x, ctx.scope("q")).reshape(b, s, self.n_heads, self.head_dim)
        if self.cross:
            return self._cross(params, q, ctx, cache=cache, kv_src=kv_src)
        k = self.wk(params["k"], x, ctx.scope("k")).reshape(b, s, self.n_kv, self.head_dim)
        v = self.wv(params["v"], x, ctx.scope("v")).reshape(b, s, self.n_kv, self.head_dim)
        if positions is None:
            positions = torch.arange(s, device=x.device)
        if self.use_rope:
            q = apply_rope(q, positions, self.rope_theta)
            k = apply_rope(k, positions, self.rope_theta)

        if cache is None:
            if self.causal or self.window is not None or self.n_kv != self.n_heads:
                out = flash_attention_train(q, k, v, causal=self.causal, window=self.window,
                                            block_q=self.block_q, block_kv=self.block_kv)
            else:
                out = attention(q, k, v)
            return self.wo(params["o"], out.reshape(b, s, -1), ctx.scope("o"))

        idx, length = cache["idx"], cache["k"].shape[1]
        kc, vc = k.to(cache["k"].dtype), v.to(cache["v"].dtype)
        mask = dict(causal=self.causal, window=self.window)
        if s == 1:  # decode: one row per lane at its ring slot
            lanes = torch.arange(b, device=x.device)
            slot = idx % length
            cache["k"][lanes, slot] = kc[:, 0]
            cache["v"][lanes, slot] = vc[:, 0]
            cache["pos"][lanes, slot] = idx
            if length >= self.cp_threshold:
                out = blocked_decode_attention(q, cache["k"], cache["v"], cache["pos"], idx,
                                               n_blocks=self.cp_blocks, window=self.window)
            else:
                out = dispatch.flash_attention(q, cache["k"], cache["v"], q_offset=idx,
                                               kv_positions=cache["pos"], **mask)
        elif s <= length:  # prefill from empty (idx 0): the prompt's own K/V
            cache["k"][:, :s] = kc
            cache["v"][:, :s] = vc
            cache["pos"][:, :s] = torch.arange(s, device=x.device)
            out = dispatch.flash_attention(q, kc, vc, **mask)
        else:  # ring prefill: only the last ``length`` rows stay reachable
            shift = s % length
            cache["k"].copy_(torch.roll(kc[:, s - length:], shift, dims=1))
            cache["v"].copy_(torch.roll(vc[:, s - length:], shift, dims=1))
            ring = torch.roll(torch.arange(s - length, s, device=x.device), shift)
            cache["pos"].copy_(ring.expand(b, length))
            out = dispatch.flash_attention(q, kc, vc, **mask)
        idx += s
        y = self.wo(params["o"], out.reshape(b, s, -1), ctx.scope("o"))
        return y, cache

    def _cross(self, params: Params, q: torch.Tensor, ctx: Ctx, *, cache: Optional[dict],
               kv_src: Optional[torch.Tensor]):
        """Cross-attention of q (B, Sq, H, hd) over ``kv_src``'s projections,
        or, with a cache and no ``kv_src`` (decode), over the cached ones."""
        b, s = q.shape[:2]
        if kv_src is None:
            if cache is None:
                raise ValueError(f"{self.name}: cross-attention needs kv_src or a filled cache")
            k, v = cache["k"], cache["v"]  # the encoder's projections, from the prefill
        else:
            skv = kv_src.shape[1]
            k = self.wk(params["k"], kv_src, ctx.scope("k")).reshape(b, skv, self.n_kv,
                                                                     self.head_dim)
            v = self.wv(params["v"], kv_src, ctx.scope("v")).reshape(b, skv, self.n_kv,
                                                                     self.head_dim)
            if cache is not None:
                cache["k"].copy_(k)
                cache["v"].copy_(v)
        if cache is None:
            out = flash_attention_train(q, k, v, causal=False, block_q=self.block_q,
                                        block_kv=self.block_kv)
            return self.wo(params["o"], out.reshape(b, s, -1), ctx.scope("o"))
        out = dispatch.flash_attention(q, k, v, causal=False)
        return self.wo(params["o"], out.reshape(b, s, -1), ctx.scope("o")), cache
