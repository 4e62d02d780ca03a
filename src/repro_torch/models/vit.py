"""Paper-native Vision Transformer classifier (port of ``models/vit.py``).

The convolutional ViT/BEiT of the paper's Table 5: a VALID strided
``Conv2d`` patch embedding (a ghost tap with T = patches), a learned
position ``Embedding`` over ``arange(T)`` (the embedding tap), a
``ScannedStack`` of pre-norm transformer blocks (each layer
rematerialised in the backward when ``cfg.remat``, the default), a final LayerNorm, mean
pooling over patches and a ``Dense`` head on a T = 1 tap.  Compute runs in
``cfg.dtype`` (bf16 for ViT-Base) with parameters in ``cfg.param_dtype``
(fp32).  The public batch is the JAX package's: ``batch["image"]``
(B, H, W, C), ``batch["label"]`` (B,), ``batch["mask"]`` (B,).

On a model axis the patch embedding splits its output channels and
gathers them (``nn/conv.py``), so the whole ``pos_embed`` and the residual
stream see all of them; the blocks run tensor-parallel as the LMs' do, and
the head's logits are gathered where the classes split.

``device``: ``None`` is the GPU (and raises without one), ``"cpu"`` must be
asked for.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig, torch_dtype
from repro_torch.core.taps import Ctx
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.blocks import TransformerBlock
from repro_torch.models.cnn import head_logits
from repro_torch.models.losses import per_sample_xent
from repro_torch.nn.conv import Conv2d
from repro_torch.nn.module import Dense, Embedding, LayerNorm
from repro_torch.nn.stack import ScannedStack


class ViT:
    def __init__(self, cfg: ArchConfig, *, image_size: int = 224, patch: int = 16,
                 n_classes: int = 1000, in_ch: int = 3, device: DeviceLike = None):
        self.cfg = cfg
        self.device = dev = resolve_device(device)
        self.dtype = dtype = torch_dtype(cfg.dtype)
        common = dict(dtype=dtype, param_dtype=torch_dtype(cfg.param_dtype), device=dev)
        self.n_patches = (image_size // patch) ** 2
        self.patch_embed = Conv2d("patch_embed", in_ch, cfg.d_model, (patch, patch),
                                  strides=(patch, patch), padding="VALID", **common)
        self.pos_embed = Embedding("pos_embed", self.n_patches, cfg.d_model,
                                   axes_=(None, "embed"), **common)
        block = TransformerBlock(
            "vb", dataclasses.replace(cfg, norm="layernorm", act="gelu"), causal=False,
            **common,
        )
        self.layers = ScannedStack("layers", block, cfg.n_layers, remat=cfg.remat)
        self.norm_f = LayerNorm("norm_f", cfg.d_model, **common)
        self.head = Dense("head", cfg.d_model, n_classes, **common)
        self.conv_weights = (self.patch_embed.weight_path,)

    def init(self, generator: torch.Generator) -> dict:
        return {
            "patch_embed": self.patch_embed.init(generator),
            "pos_embed": self.pos_embed.init(generator),
            "layers": self.layers.init(generator),
            "norm_f": self.norm_f.init(generator),
            "head": self.head.init(generator),
        }

    def axes(self) -> dict:
        return {
            "patch_embed": self.patch_embed.axes(),
            "pos_embed": self.pos_embed.axes(),
            "layers": self.layers.axes(),
            "norm_f": self.norm_f.axes(),
            "head": self.head.axes(),
        }

    def logits(self, params, image, ctx: Ctx) -> torch.Tensor:
        x = self.patch_embed(params["patch_embed"], image.to(self.dtype),
                             ctx.scope("patch_embed"))
        b = x.shape[0]
        x = x.reshape(b, -1, self.cfg.d_model)
        pos = torch.arange(x.shape[1], device=x.device).expand(b, -1)
        x = x + self.pos_embed(params["pos_embed"], pos, ctx.scope("pos_embed"))
        x = self.layers(params["layers"], x, ctx.scope("layers"))
        x = self.norm_f(params["norm_f"], x, ctx.scope("norm_f"))
        return head_logits(self.head, params["head"], x.mean(dim=1), ctx)

    def loss_with_ctx(self, params, batch, ctx: Ctx) -> torch.Tensor:
        logits = self.logits(params, batch["image"], ctx)
        return per_sample_xent(logits[:, None, :], batch["label"][:, None], batch.get("mask"))
