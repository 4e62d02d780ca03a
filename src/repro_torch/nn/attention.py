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

On a model axis (training; ``reshard.model_dim``) the q/k/v projections
are column-parallel and ``o`` row-parallel, and a rank attends with the
heads its columns hold: with "heads" split whole heads to a rank (``H %
model == 0``) its q heads ``[r H/m, (r + 1) H/m)``, each with its global KV
head (GQA).  K/V projections split the same way give those KV heads
locally; K/V that stay whole (``copy_to_model``: each rank's heads add to
their gradient) or split inside a head (``gather_along_sum``) are taken
whole and the needed heads picked.  Where "heads" splits inside a head,
every rank gathers q and attends with all heads, and hands ``o`` its own
columns.

Serving on the model axis, the layout chosen by the serve state's
placements (``parallel.sharding.local_serve_shardings``), never by the
call: a rank takes its q heads as in training, and its cache holds

- this rank's KV heads (a cache shorter than 32768 rows whose KV heads
  divide the axis: Mixtral's 4096-row ring), exactly the heads its q heads
  read: prefill, ring prefill and decode run on them unchanged;
- every KV head (the heads do not divide): the new rows are gathered whole,
  and the rank reads the KV heads its q heads need;
- every KV head of rows ``[c S / n, (c + 1) S / n)`` on rank ``c`` of
  ``reshard.cache_seq_group()`` (a cache of 32768 rows or more: context
  parallelism; also under ``dp_only``, where the weights are whole).  A
  prefill gathers the prompt's KV heads, attends through the kernel with
  the rank's q heads and keeps the rows of the rank's positions; a decode
  step writes each lane's row on the rank that owns its slot, gathers the
  query's heads, takes every head's partial softmax ``(o, m, l)`` over the
  rank's rows (``decode_partials``: the flash form's one block, or the
  blocked form's ``cp_blocks / n``) and merges the ranks' partials
  (``collectives.merge_softmax``, as ``blocked_decode_attention`` merges
  its blocks), keeping the rank's heads for the row-parallel ``o``.  Where
  the JAX package leaves this plan to GSPMD, the merge here is explicit.

Cross-attention runs on the ``dp_only`` families only, whose weights are
whole: its cache stays whole.

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
from repro_torch.parallel import collectives, reshard


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
    o, _, l = decode_partials(q, k, v, pos, qpos, n_blocks=n_blocks, window=window)
    o = o / l.clamp_min(1e-30)[..., None]
    return o.reshape(b, 1, h, hd).to(q.dtype)


def decode_partials(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos: torch.Tensor, qpos: torch.Tensor,
    *, n_blocks: int = 1, window: Optional[int] = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The partial softmax of one query per lane over the cache rows given,
    fp32: (o (B, K, g, hd), the unnormalised sum of exp(s - m) v; m (B, K,
    g), the largest live score, -1e30 where no row is live; l (B, K, g), the
    sum of exp(s - m)), from a partial per block of S / n_blocks rows
    combined over the blocks.  A masked row adds nothing, so a cache with no
    live row gives o = 0, l = 0."""
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
    live = mask[:, :, None, None, :]
    scores = scores.masked_fill(~live, -1e30)

    m_b = scores.amax(dim=-1)  # (B, nb, K, g)
    p = torch.exp(scores - m_b[..., None]) * live
    l_b = p.sum(dim=-1)
    o_b = torch.einsum("bnkgs,bnskd->bnkgd", p, vb)
    # combine across blocks (the JAX package's only cross-shard reduction)
    m = m_b.amax(dim=1, keepdim=True)
    w = torch.exp(m_b - m)
    return (w[..., None] * o_b).sum(dim=1), m[:, 0], (w * l_b).sum(dim=1)


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
        q = self.wq(params["q"], x, ctx.scope("q"))
        if self.cross:
            q = q.reshape(b, s, self.n_heads, self.head_dim)
            return self._cross(params, q, ctx, cache=cache, kv_src=kv_src)
        k = self.wk(params["k"], x, ctx.scope("k"))
        v = self.wv(params["v"], x, ctx.scope("v"))
        if positions is None:
            positions = torch.arange(s, device=x.device)
        if cache is not None:
            return self._serve(params, q, k, v, ctx, positions, cache)
        narrow_out = False
        if reshard.model_size() > 1:
            q, k, v, narrow_out = self._model_heads(q, k, v)
        else:
            q = q.reshape(b, s, self.n_heads, self.head_dim)
            k = k.reshape(b, s, self.n_kv, self.head_dim)
            v = v.reshape(b, s, self.n_kv, self.head_dim)
        if self.use_rope:
            q = apply_rope(q, positions, self.rope_theta)
            k = apply_rope(k, positions, self.rope_theta)
        if self.causal or self.window is not None or self.n_kv != self.n_heads:
            out = flash_attention_train(q, k, v, causal=self.causal, window=self.window,
                                        block_q=self.block_q, block_kv=self.block_kv)
        else:
            out = attention(q, k, v)
        out = out.reshape(b, s, -1)
        if narrow_out:  # every head computed here; o takes this rank's columns
            out = collectives.split_along(out, -1, reshard.model_group())
        return self.wo(params["o"], out, ctx.scope("o"))

    def _serve(self, params: Params, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               ctx: Ctx, positions: torch.Tensor, cache: dict):
        """A prefill or decode step over ``cache`` from the projections'
        outputs (B, S, columns), writing the new rows in place: (y, cache).
        The cache's layout is its placement's: whole, this rank's KV heads
        (its shapes say so: the heads its q heads read), or, where the serve
        step's placements split the rows (``reshard.cache_seq_group()``),
        rows ``[c S / n, (c + 1) S / n)`` of every KV head on rank ``c`` of
        that group."""
        b, s = q.shape[:2]
        hd, heads, kv = self.head_dim, self.n_heads, self.n_kv
        n, group = reshard.model_size(), reshard.model_group()
        q_split = q.shape[-1] != heads * hd
        local = q_split and heads % n == 0  # whole q heads to a rank
        if q_split and not local:  # split inside a head: every rank attends with all
            q = collectives.all_gather_dim(q, -1, group)
        first, hq = (reshard.model_coord() * heads // n, heads // n) if local else (0, heads)
        if k.shape[-1] % hd:  # K/V split inside a head: taken whole
            k, v = (collectives.all_gather_dim(x, -1, group) for x in (k, v))
        q, k, v = (x.reshape(b, s, -1, hd) for x in (q, k, v))
        if self.use_rope:
            q = apply_rope(q, positions, self.rope_theta)
            k = apply_rope(k, positions, self.rope_theta)
        cached, seq_group = cache["k"].shape[2], reshard.cache_seq_group()
        if cached == kv and k.shape[2] != kv:  # a whole cache of heads split by rank
            k, v = (collectives.all_gather_dim(x, 2, group) for x in (k, v))
        elif cached != k.shape[2] or (seq_group is not None and cached != kv):
            raise ValueError(f"{self.name}: a cache of {cached} KV heads, this rank's "
                             f"projections give {k.shape[2]} of {kv}")
        g = heads // kv
        need = [(first + i) // g for i in range(hq)] if cached == kv else None
        kc, vc = k.to(cache["k"].dtype), v.to(cache["v"].dtype)
        mask = dict(causal=self.causal, window=self.window)
        idx = cache["idx"]
        if seq_group is not None:
            out = self._serve_rows(q, kc, vc, cache, seq_group, need, first, hq, mask)
        elif s == 1:  # decode: one row per lane at its ring slot
            length = cache["k"].shape[1]
            lanes = torch.arange(b, device=q.device)
            slot = idx % length
            cache["k"][lanes, slot] = kc[:, 0]
            cache["v"][lanes, slot] = vc[:, 0]
            cache["pos"][lanes, slot] = idx
            ck, cv = _needed(cache["k"], cache["v"], need)
            if length >= self.cp_threshold:
                out = blocked_decode_attention(q, ck, cv, cache["pos"], idx,
                                               n_blocks=self.cp_blocks, window=self.window)
            else:
                out = dispatch.flash_attention(q, ck, cv, q_offset=idx,
                                               kv_positions=cache["pos"], **mask)
        else:
            rows, pos = _prefill_rows(kc, vc, cache["k"].shape[1])
            cache["k"][:, :rows[0].shape[1]] = rows[0]
            cache["v"][:, :rows[1].shape[1]] = rows[1]
            cache["pos"][:, :pos.shape[0]] = pos
            out = dispatch.flash_attention(q, *_needed(kc, vc, need), **mask)
        idx += s
        out = out.reshape(b, s, -1)
        if q_split and not local:  # every head computed here; o takes this rank's columns
            out = collectives.split_along(out, -1, group)
        return self.wo(params["o"], out, ctx.scope("o")), cache

    def _serve_rows(self, q, kc, vc, cache: dict, group, need, first: int, hq: int,
                    mask: dict) -> torch.Tensor:
        """Prefill or decode over a cache whose rows are split over ``group``
        (context parallelism), every KV head whole: (B, S, hq, hd), this
        rank's q heads.  A prefill attends over the prompt's own K/V through
        the kernel and keeps the rows of this rank's positions; a decode
        writes each lane's row on the rank that owns its slot, gathers the
        query's heads, takes a partial softmax over this rank's rows for
        every head (``decode_partials``: one block, or ``cp_blocks / n``
        once the cache holds ``cp_threshold`` rows) and merges the ranks'
        partials (``collectives.merge_softmax``)."""
        b, s = q.shape[:2]
        dist = torch.distributed
        n, c = dist.get_world_size(group), dist.get_rank(group)
        rows = cache["k"].shape[1]
        length = rows * n
        lo = c * rows
        if s > 1:  # the prompt's rows of this rank's positions
            (k_rows, v_rows), pos = _prefill_rows(kc, vc, length)
            cnt = max(0, min(pos.shape[0] - lo, rows))
            cache["k"][:, :cnt] = k_rows[:, lo:lo + cnt]
            cache["v"][:, :cnt] = v_rows[:, lo:lo + cnt]
            cache["pos"][:, :cnt] = pos[lo:lo + cnt]
            return dispatch.flash_attention(q, *_needed(kc, vc, need), **mask)
        idx = cache["idx"]
        lanes = torch.arange(b, device=q.device)
        slot = idx % length
        mine = (slot // rows) == c  # the lanes whose new row this rank holds
        at = slot % rows
        for name, new in (("k", kc[:, 0]), ("v", vc[:, 0]), ("pos", idx)):
            old = cache[name][lanes, at]
            cache[name][lanes, at] = torch.where(mine.reshape(-1, *[1] * (new.ndim - 1)),
                                                 new, old)
        if hq != self.n_heads:
            q = collectives.all_gather_dim(q, 2, reshard.model_group())
        blocks = self.cp_blocks // n if length >= self.cp_threshold else 1
        o, m, l = decode_partials(q, cache["k"], cache["v"], cache["pos"], idx,
                                  n_blocks=blocks, window=self.window)
        out = collectives.merge_softmax(o, m, l, group).reshape(b, 1, self.n_heads, -1)
        return out[:, :, first:first + hq].to(q.dtype)

    def _model_heads(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
        """This rank's attention heads on the model axis, from the projections'
        outputs (B, S, columns): (q (B, S, hq, hd), k, v (B, S, hk, hd),
        whether ``o``'s input must be narrowed to this rank's columns)."""
        n, r, group = reshard.model_size(), reshard.model_coord(), reshard.model_group()
        b, s = q.shape[:2]
        hd, heads, kv = self.head_dim, self.n_heads, self.n_kv
        q_split, kv_split = q.shape[-1] != heads * hd, k.shape[-1] != kv * hd
        local = q_split and heads % n == 0  # whole heads to a rank
        if q_split and not local:  # split inside a head: every rank attends with all
            q = collectives.gather_along(q, -1, group)
        first, hq = (r * heads // n, heads // n) if local else (0, heads)
        group_size = heads // kv
        need = [(first + i) // group_size for i in range(hq)]  # each q head's KV head
        lo, hi = need[0], need[-1] + 1
        if not (kv_split and kv % n == 0 and local and lo == r * kv // n and hi - lo == kv // n):
            if kv_split:  # taken whole; the others' heads add to its gradient if local
                gather = collectives.gather_along_sum if local else collectives.gather_along
                k, v = gather(k, -1, group), gather(v, -1, group)
            elif local:  # whole on every rank, used by this rank's heads only
                k, v = collectives.copy_to_model(k, group), collectives.copy_to_model(v, group)
            k, v = _needed(*(x.reshape(b, s, kv, hd) for x in (k, v)), need)
        q = q.reshape(b, s, hq, hd)
        k, v = (x.reshape(b, s, -1, hd) for x in (k, v))
        return q, k, v, q_split and not local

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


def _needed(k: torch.Tensor, v: torch.Tensor, need: Optional[list]) -> tuple:
    """The KV heads (dim 2) that q heads read, ``need[i]`` for q head i: a
    GQA block as a view, else one KV head per q head; all of them for
    ``need`` None."""
    if need is None:
        return k, v
    lo, hi, hq = need[0], need[-1] + 1, len(need)
    if hq % (hi - lo) == 0 and need == [lo + i * (hi - lo) // hq for i in range(hq)]:
        return k[:, :, lo:hi], v[:, :, lo:hi]
    idx = torch.tensor(need, device=k.device)
    return k.index_select(2, idx), v.index_select(2, idx)


def _prefill_rows(k: torch.Tensor, v: torch.Tensor, length: int) -> tuple:
    """A prompt's cache rows from an empty cache of ``length`` rows:
    ((k, v) (B, R, K, hd), positions (R,)), rows 0..R-1.  A prompt that fits
    fills its own rows; a longer one (a window's ring) keeps its last
    ``length``, slot ``j`` holding position ``p`` with ``p % length == j``."""
    s = k.shape[1]
    if s <= length:
        return (k, v), torch.arange(s, device=k.device)
    shift = s % length
    ring = torch.roll(torch.arange(s - length, s, device=k.device), shift)
    return tuple(torch.roll(x[:, s - length:], shift, dims=1) for x in (k, v)), ring
