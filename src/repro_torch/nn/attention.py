"""Grouped-query attention with RoPE, causal and sliding-window masks and a
KV cache (port of ``nn/attention.py``).

The projections are ``Dense`` modules, so each gets a DP tap; the
attention itself has no parameters and the clipping engine never sees it.

Without a cache (training) attention runs in fp32 outside any kernel, as
the JAX package computes it outside any Pallas kernel.  Causal, windowed or
grouped-head attention (the decoder LMs) goes through
``flash_attention_train``, the JAX package's blocked attention with its
custom VJP (``block_q`` / ``block_kv`` from the configuration); the ViT's
bidirectional MHA keeps the plain softmax on fp32 copies of q, k and v.
Both run the same ops in every backward, so ``mixed_ghost``'s second
backward over the retained graph repeats the first's arithmetic.

With a cache (serving) the three branches of the JAX module:

- decode (``s == 1``): each lane writes its row at ``idx % length`` and
  attends over its cache with the plain serving form of
  ``dispatch.flash_attention`` (per-lane ``kv_positions`` and ``q_offset``);
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

Divergences by design: the cache's ``pos`` (B, length) and ``idx`` (B,)
are per lane, where the JAX cache has one ``pos`` (length,) and a scalar
``idx`` under the engine's ``vmap``, so one batched decode serves lanes at
different fill levels; and a block writes its new rows into the cache it
is given, in place (``DecoderLM`` hands it a copy).  The JAX package's
``blocked_decode_attention`` (context-parallel decode at cache lengths of
65536 and more) and cross-attention are not ported yet; decode at any
length runs the serving form, which computes the same function.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.taps import Ctx
from repro_torch.kernels import dispatch
from repro_torch.kernels.flash_attention.ops import flash_attention_train
from repro_torch.nn.module import Dense, Module, Params
from repro_torch.nn.rotary import apply_rope


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Bidirectional softmax attention in fp32: q, k, v (B, S, H, hd) ->
    (B, S, H, hd) in q's dtype."""
    hd = q.shape[-1]
    qf, kf, vf = (x.float().transpose(1, 2) for x in (q, k, v))  # (B, H, S, hd)
    probs = torch.softmax(qf @ kf.transpose(-1, -2) * hd**-0.5, dim=-1)
    return (probs @ vf).transpose(1, 2).to(q.dtype)


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
        block_q: int = 512, block_kv: int = 512,
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
        self.block_q = block_q
        self.block_kv = block_kv
        common = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.wq = Dense(f"{name}.q", d_model, n_heads * self.head_dim, use_bias=qkv_bias,
                        **common)
        self.wk = Dense(f"{name}.k", d_model, n_kv * self.head_dim, use_bias=qkv_bias,
                        **common)
        self.wv = Dense(f"{name}.v", d_model, n_kv * self.head_dim, use_bias=qkv_bias,
                        **common)
        self.wo = Dense(f"{name}.o", n_heads * self.head_dim, d_model, use_bias=False,
                        **common)

    def init(self, generator: torch.Generator) -> Params:
        return {
            "q": self.wq.init(generator),
            "k": self.wk.init(generator),
            "v": self.wv.init(generator),
            "o": self.wo.init(generator),
        }

    def __call__(
        self, params: Params, x: torch.Tensor, ctx: Ctx, *,
        positions: Optional[torch.Tensor] = None,  # (S,) or (B, S)
        cache: Optional[dict] = None,
    ):
        """Without ``cache`` returns y; with it, (y, cache) after writing the
        new rows into ``cache`` in place."""
        b, s, _ = x.shape
        q = self.wq(params["q"], x, ctx.scope("q")).reshape(b, s, self.n_heads, self.head_dim)
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
