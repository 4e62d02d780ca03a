"""Decoder-only language model: the dense, MoE, hybrid (Jamba: Mamba and
attention), SSM (xLSTM) and VLM (Phi-3-vision) families (port of
``models/lm.py``).

The entry points of the JAX package's ``DecoderLM``, and one more:

- ``loss_with_ctx(params, batch, ctx)``   per-sample losses (B,) with the
  DP taps threaded: the clipping engines' model function
- ``init_state(batch, max_len)``          an empty cache per layer: KV rows
  for attention, the conv and SSM states for Mamba and mLSTM, the
  sLSTM's ``h``, ``c``, ``n`` and ``m``
- ``prefill(params, batch, state)``       the prompt's forward + cache fill;
  the lm_head runs on the last position only
- ``decode_step(params, tokens, state)``  one token per lane
- ``forward_logits(params, batch)``       every text position's logits
  with no cache, the teacher-forced reference of the two above

Training dispatches the experts per sample (each sample's tokens fill its
own capacity, so per-sample clipping stays exact) and ``prefill``
globally, as the JAX package threads ``dispatch`` through its trunk.
``decode_step`` dispatches per lane: its B lanes are the serving engine's
independent requests, which the JAX engine decodes as ``vmap`` of a B=1
step (each lane its own capacity), so a lane's tokens never depend on its
neighbours' routing and the engine's streams equal ``sequential_decode``'s.
A JAX ``decode_step`` called on B > 1 outside the engine dispatches over
all B tokens; the two agree whenever no expert overflows its capacity.

With ``cfg.remat`` every layer is recomputed in the backward
(``ScannedStack``) and so is the head with its loss (``head_loss`` under
non-reentrant ``torch.utils.checkpoint``): the (B, S, V) logits are the
largest activation of a step, and only the head's input is kept.

A state is ``{"cache": ..., "pos": (B,)}``: every cache leaf is (L, B, ...)
and ``pos`` counts each lane's tokens, so the lanes of one batched decode
may sit at different positions (RoPE and masks per lane).  ``prefill`` and
``decode_step`` copy the state they are given and fill the copy, so a
caller's state is never written.  Compute runs in ``cfg.dtype`` with
parameters in ``cfg.param_dtype``.

A recurrent layer's state is the same at every position, so its cache
does not grow with the prompt; the serving engine carries it in its dense
per-lane state.

The VLM family (``cfg.prefix_tokens``): ``batch["prefix"]`` (B,
prefix_tokens, prefix_dim) holds the image tower's patch embeddings (the
JAX package's stub for CLIP ViT-L/14), which the ``prefix_proj`` Dense (a
DP tap) maps to d_model and ``_trunk`` puts before the text tokens; the
positions run over both.  ``loss_with_ctx`` drops the prefix positions
before the head, and ``prefill`` counts them in ``pos``.  The
encoder-decoder family is ``models/encdec.py``'s ``EncDecLM``.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig, torch_dtype
from repro_torch.core.taps import Ctx
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.blocks import build_period
from repro_torch.models.losses import per_sample_xent
from repro_torch.nn.module import Dense, Embedding, LayerNorm, RMSNorm
from repro_torch.nn.stack import ScannedStack
from repro_torch.utils.tree import tree_map


class DecoderLM:
    def __init__(self, cfg: ArchConfig, *, device: DeviceLike = None):
        if cfg.family not in ("dense", "moe", "hybrid", "ssm", "vlm") or cfg.encoder_layers:
            raise ValueError(
                f"{cfg.name} ({cfg.family}): DecoderLM builds the dense, MoE, hybrid, SSM and "
                "VLM families; the encoder-decoder is EncDecLM"
            )
        self.cfg = cfg
        self.device = dev = resolve_device(device)
        self.dtype = dtype = torch_dtype(cfg.dtype)
        common = dict(dtype=dtype, param_dtype=torch_dtype(cfg.param_dtype), device=dev)
        d = cfg.d_model
        self.embed = Embedding("embed", cfg.vocab, d, **common)
        self.use_learned_pos = cfg.norm == "layernorm"
        if self.use_learned_pos:
            self.pos_embed = Embedding("pos_embed", max(cfg.encoder_seq, 32768), d,
                                       axes_=(None, "embed"), **common)
        if cfg.prefix_tokens:
            self.prefix_proj = Dense("prefix_proj", cfg.prefix_dim, d, use_bias=True,
                                     w_axes=(None, "embed"), **common)
        period, n_periods = build_period(cfg, **common)
        self.layers = ScannedStack("layers", period, n_periods, remat=cfg.remat)
        norm_cls = RMSNorm if cfg.norm == "rmsnorm" else LayerNorm
        self.norm_f = norm_cls("norm_f", d, **common)
        self.lm_head = Dense("lm_head", d, cfg.vocab, use_bias=False,
                             w_axes=("embed", "vocab"), **common)
        self.conv_weights: tuple[str, ...] = ()  # no conv layer

    # -- params ------------------------------------------------------------
    def init(self, generator: torch.Generator) -> dict:
        p = {
            "embed": self.embed.init(generator),
            "layers": self.layers.init(generator),
            "norm_f": self.norm_f.init(generator),
            "lm_head": self.lm_head.init(generator),
        }
        if self.use_learned_pos:
            p["pos_embed"] = self.pos_embed.init(generator)
        if self.cfg.prefix_tokens:
            p["prefix_proj"] = self.prefix_proj.init(generator)
        return p

    def axes(self) -> dict:
        a = {
            "embed": self.embed.axes(),
            "layers": self.layers.axes(),
            "norm_f": self.norm_f.axes(),
            "lm_head": self.lm_head.axes(),
        }
        if self.use_learned_pos:
            a["pos_embed"] = self.pos_embed.axes()
        if self.cfg.prefix_tokens:
            a["prefix_proj"] = self.prefix_proj.axes()
        return a

    # -- shared trunk --------------------------------------------------------
    def _trunk(self, params, tokens: torch.Tensor, ctx: Ctx, *,
               prefix: Optional[torch.Tensor] = None, cache: Optional[dict] = None,
               positions: Optional[torch.Tensor] = None, dispatch: str = "per_sample"):
        """Embeddings (the projected ``prefix`` first, where given), the
        layers and the final norm: (x, cache), the cache None without one
        (training)."""
        x = self.embed(params["embed"], tokens, ctx.scope("embed"))
        if prefix is not None:
            pe = self.prefix_proj(params["prefix_proj"], prefix.to(self.dtype),
                                  ctx.scope("prefix_proj"))
            x = torch.cat([pe, x], dim=1)
        b, s = x.shape[:2]
        if positions is None:
            positions = torch.arange(s, device=x.device)
        if self.use_learned_pos:
            x = x + self.pos_embed(params["pos_embed"], positions.expand(b, s),
                                   ctx.scope("pos_embed"))
        out = self.layers(params["layers"], x, ctx.scope("layers"), cache=cache,
                          positions=positions, dispatch=dispatch)
        x, cache = (out, None) if cache is None else out
        return self.norm_f(params["norm_f"], x, ctx.scope("norm_f")), cache

    # -- training ------------------------------------------------------------
    def loss_with_ctx(self, params, batch, ctx: Ctx) -> torch.Tensor:
        """Per-sample mean token cross-entropy (B,): ``batch["tokens"]`` and
        ``batch["labels"]`` (B, S), -100 ignored, an optional ``mask`` (B,);
        a VLM's ``prefix`` positions are dropped before the head."""
        prefix = batch.get("prefix")
        x, _ = self._trunk(params, batch["tokens"], ctx, prefix=prefix)
        if prefix is not None:
            x = x[:, prefix.shape[1]:]

        def head_loss(head_params, x_in):
            logits = self.lm_head(head_params, x_in, ctx.scope("lm_head"))
            return per_sample_xent(logits, batch["labels"], batch.get("mask"))

        if self.cfg.remat and ctx.remat and torch.is_grad_enabled():
            return checkpoint(head_loss, params["lm_head"], x, use_reentrant=False,
                              preserve_rng_state=False)
        return head_loss(params["lm_head"], x)

    def forward_logits(self, params, batch: dict) -> torch.Tensor:
        """Logits (B, S, V) of every text position from one forward with no
        cache (a VLM's ``prefix`` before the tokens): the teacher-forced
        reference of ``prefill`` and ``decode_step``."""
        prefix = batch.get("prefix")
        x, _ = self._trunk(params, batch["tokens"], Ctx.disabled(), prefix=prefix)
        if prefix is not None:
            x = x[:, prefix.shape[1]:]
        return self.lm_head(params["lm_head"], x, Ctx.disabled())

    # -- serving -------------------------------------------------------------
    def init_state(self, batch: int, max_len: int) -> dict:
        cache = self.layers.init_cache(batch, self.dtype, max_len=max_len)
        return {"cache": cache, "pos": torch.zeros((batch,), dtype=torch.long,
                                                   device=self.device)}

    def prefill(self, params, batch: dict, state: dict) -> tuple[torch.Tensor, dict]:
        """Prompts ``batch["tokens"]`` (B, S), after a VLM's ``prefix``, into
        an empty state: logits of the last position (B, 1, V) and the filled
        state, whose ``pos`` counts the prefix."""
        state = tree_map(torch.clone, state)
        x, cache = self._trunk(params, batch["tokens"], Ctx.disabled(),
                               prefix=batch.get("prefix"), cache=state["cache"],
                               dispatch="global")
        logits = self.lm_head(params["lm_head"], x[:, -1:], Ctx.disabled())
        return logits, {"cache": cache, "pos": state["pos"] + x.shape[1]}

    def decode_step(self, params, tokens: torch.Tensor, state: dict) -> tuple[torch.Tensor, dict]:
        """``tokens`` (B, S) at each lane's next positions -> logits (B, S, V)."""
        state = tree_map(torch.clone, state)
        positions = state["pos"][:, None] + torch.arange(tokens.shape[1], device=tokens.device)
        x, cache = self._trunk(params, tokens, Ctx.disabled(), cache=state["cache"],
                               positions=positions, dispatch="per_sample")  # per lane
        logits = self.lm_head(params["lm_head"], x, Ctx.disabled())
        return logits, {"cache": cache, "pos": state["pos"] + tokens.shape[1]}

