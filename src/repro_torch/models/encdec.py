"""Encoder-decoder transformer: Whisper-large-v3's backbone (port of
``models/encdec.py``).

The audio conv frontend is the JAX package's stub: ``batch["frames"]``
holds precomputed frame embeddings (B, enc_seq, d_model) in place of the
mel -> conv1d -> GELU stem.  Everything after it is real and clipped: the
learned encoder positions, the encoder stack (bidirectional LayerNorm/GELU
blocks, plain fp32 attention, ``nn/attention.py``), the decoder's token and
position embeddings, and the decoder stack of causal self-attention,
cross-attention over the encoder states and MLP.

The entry points are ``DecoderLM``'s (``models/lm.py``):

- ``loss_with_ctx(params, batch, ctx)``   per-sample losses (B,) from
  ``frames`` (B, enc_seq, d), ``tokens`` and ``labels`` (B, S);
- ``init_state(batch, max_len)``          an empty cache per decoder layer:
  the self-attention's KV rows and the cross-attention's ``xkv``
  (B, enc_seq, K, hd);
- ``prefill(params, batch, state)``       encode ``frames``, run the prompt
  and fill both caches; logits of the last position only;
- ``decode_step(params, tokens, state)``  one token per lane; the
  cross-attention reads the cached encoder projections (no ``frames``);
- ``forward_logits(params, batch)``       every position's logits with no
  cache, the teacher-forced reference of the two above.

The serving-state conventions are ``DecoderLM``'s: ``pos`` is per lane
(B,), and ``prefill`` / ``decode_step`` copy the state and fill the copy.
With ``cfg.remat`` both stacks recompute each layer in the backward and
the head runs with its loss under checkpoint, as ``DecoderLM`` does (the
JAX ``EncDecLM`` keeps its head's logits: the same function, more memory).
The model has no conv layer (``conv_weights = ()``).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig, torch_dtype
from repro_torch.core.taps import Ctx
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.blocks import TransformerBlock
from repro_torch.models.losses import per_sample_xent
from repro_torch.nn.module import Dense, Embedding, LayerNorm
from repro_torch.nn.stack import ScannedStack
from repro_torch.utils.tree import tree_map


class EncDecLM:
    def __init__(self, cfg: ArchConfig, *, device: DeviceLike = None):
        if cfg.family != "audio" or not cfg.encoder_layers or not cfg.encoder_seq:
            raise ValueError(f"{cfg.name} ({cfg.family}): EncDecLM builds the audio family, "
                             "with encoder_layers and encoder_seq set")
        self.cfg = cfg
        self.device = dev = resolve_device(device)
        self.dtype = dtype = torch_dtype(cfg.dtype)
        common = dict(dtype=dtype, param_dtype=torch_dtype(cfg.param_dtype), device=dev)
        d = cfg.d_model
        self.enc_pos = Embedding("enc_pos", cfg.encoder_seq, d, axes_=(None, "embed"), **common)
        enc_block = TransformerBlock("eb", cfg, cross=False, causal=False, **common)
        self.encoder = ScannedStack("encoder", enc_block, cfg.encoder_layers, remat=cfg.remat)
        self.enc_norm = LayerNorm("enc_norm", d, **common)
        self.embed = Embedding("embed", cfg.vocab, d, **common)
        self.pos_embed = Embedding("pos_embed", 32768, d, axes_=(None, "embed"), **common)
        dec_block = TransformerBlock("db", cfg, cross=True, causal=True, **common)
        self.decoder = ScannedStack("decoder", dec_block, cfg.n_layers, remat=cfg.remat)
        self.dec_norm = LayerNorm("dec_norm", d, **common)
        self.lm_head = Dense("lm_head", d, cfg.vocab, use_bias=False,
                             w_axes=("embed", "vocab"), **common)
        self.conv_weights: tuple[str, ...] = ()  # no conv layer

    def init(self, generator: torch.Generator) -> dict:
        return {
            "enc_pos": self.enc_pos.init(generator),
            "encoder": self.encoder.init(generator),
            "enc_norm": self.enc_norm.init(generator),
            "embed": self.embed.init(generator),
            "pos_embed": self.pos_embed.init(generator),
            "decoder": self.decoder.init(generator),
            "dec_norm": self.dec_norm.init(generator),
            "lm_head": self.lm_head.init(generator),
        }

    def axes(self) -> dict:
        return {
            "enc_pos": self.enc_pos.axes(),
            "encoder": self.encoder.axes(),
            "enc_norm": self.enc_norm.axes(),
            "embed": self.embed.axes(),
            "pos_embed": self.pos_embed.axes(),
            "decoder": self.decoder.axes(),
            "dec_norm": self.dec_norm.axes(),
            "lm_head": self.lm_head.axes(),
        }

    def _encode(self, params, frames: torch.Tensor, ctx: Ctx) -> torch.Tensor:
        """Frames (B, enc_seq, d) -> the encoder states (B, enc_seq, d)."""
        b, s = frames.shape[:2]
        pos = torch.arange(s, device=frames.device).expand(b, s)
        x = frames.to(self.dtype) + self.enc_pos(params["enc_pos"], pos, ctx.scope("enc_pos"))
        x = self.encoder(params["encoder"], x, ctx.scope("encoder"))
        return self.enc_norm(params["enc_norm"], x, ctx.scope("enc_norm"))

    def _decode_trunk(self, params, tokens: torch.Tensor, enc_out: Optional[torch.Tensor],
                      ctx: Ctx, *, cache: Optional[dict] = None,
                      positions: Optional[torch.Tensor] = None):
        """Token and position embeddings, the decoder stack and its final
        norm: (x, cache), the cache None without one (training)."""
        b, s = tokens.shape
        if positions is None:
            positions = torch.arange(s, device=tokens.device)
        x = self.embed(params["embed"], tokens, ctx.scope("embed"))
        x = x + self.pos_embed(params["pos_embed"], positions.expand(b, s),
                               ctx.scope("pos_embed"))
        out = self.decoder(params["decoder"], x, ctx.scope("decoder"), cache=cache,
                           positions=positions, enc_out=enc_out)
        x, cache = (out, None) if cache is None else out
        return self.dec_norm(params["dec_norm"], x, ctx.scope("dec_norm")), cache

    def loss_with_ctx(self, params, batch, ctx: Ctx) -> torch.Tensor:
        """Per-sample mean token cross-entropy (B,) of ``batch["labels"]``
        given ``frames`` and ``tokens``; -100 ignored, an optional ``mask``."""
        enc_out = self._encode(params, batch["frames"], ctx)
        x, _ = self._decode_trunk(params, batch["tokens"], enc_out, ctx)

        def head_loss(head_params, x_in):
            logits = self.lm_head(head_params, x_in, ctx.scope("lm_head"))
            return per_sample_xent(logits, batch["labels"], batch.get("mask"))

        if self.cfg.remat and ctx.remat and torch.is_grad_enabled():
            return checkpoint(head_loss, params["lm_head"], x, use_reentrant=False,
                              preserve_rng_state=False)
        return head_loss(params["lm_head"], x)

    def forward_logits(self, params, batch: dict) -> torch.Tensor:
        """Logits (B, S, V) of every token position from one forward with no
        cache: the teacher-forced reference of ``prefill`` and
        ``decode_step``."""
        ctx = Ctx.disabled()
        enc_out = self._encode(params, batch["frames"], ctx)
        x, _ = self._decode_trunk(params, batch["tokens"], enc_out, ctx)
        return self.lm_head(params["lm_head"], x, ctx)

    # -- serving -------------------------------------------------------------
    def init_state(self, batch: int, max_len: int) -> dict:
        cache = self.decoder.init_cache(batch, self.dtype, max_len=max_len,
                                        enc_seq=self.cfg.encoder_seq)
        return {"cache": cache, "pos": torch.zeros((batch,), dtype=torch.long,
                                                   device=self.device)}

    def prefill(self, params, batch: dict, state: dict) -> tuple[torch.Tensor, dict]:
        """``frames`` (B, enc_seq, d) and prompts ``tokens`` (B, S) into an
        empty state: logits of the last position (B, 1, V) and the state."""
        tokens = batch["tokens"]
        state = tree_map(torch.clone, state)
        ctx = Ctx.disabled()
        enc_out = self._encode(params, batch["frames"], ctx)
        x, cache = self._decode_trunk(params, tokens, enc_out, ctx, cache=state["cache"])
        logits = self.lm_head(params["lm_head"], x[:, -1:], ctx)
        return logits, {"cache": cache, "pos": state["pos"] + tokens.shape[1]}

    def decode_step(self, params, tokens: torch.Tensor, state: dict) -> tuple[torch.Tensor, dict]:
        """``tokens`` (B, S) at each lane's next positions -> logits (B, S, V);
        the cross-attention reads the cached encoder projections."""
        state = tree_map(torch.clone, state)
        positions = state["pos"][:, None] + torch.arange(tokens.shape[1], device=tokens.device)
        x, cache = self._decode_trunk(params, tokens, None, Ctx.disabled(),
                                      cache=state["cache"], positions=positions)
        logits = self.lm_head(params["lm_head"], x, Ctx.disabled())
        return logits, {"cache": cache, "pos": state["pos"] + tokens.shape[1]}
