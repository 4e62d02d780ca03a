"""Paper-native CNNs: VGG and pre-activation ResNet (port of ``models/cnn.py``).

The models of the paper's Tables 3/4/6, with GroupNorm in place of
BatchNorm as the paper does (BN mixes samples and is not DP-safe).  The
public batch is the JAX package's: ``batch["image"]`` (B, H, W, C) float32,
``batch["label"]`` (B,) int, ``batch["mask"]`` (B,).  Activations stay
channels-last; the convolutions hand cuDNN permuted views.

Constructors take ``device``: ``None`` is the GPU (and raises without one),
``"cpu"`` must be asked for.

``axes()`` gives the JAX modules' logical axes (the JAX models have none
of their own; their ``Conv2D``, ``GroupNorm`` and ``Dense`` pin them where
used), from which ``parallel.sharding`` places the train state.  On a
model axis every convolution splits its output channels and gathers them
(``nn/conv.py``), so GroupNorm, pooling and the residual adds run whole;
the classifier's logits, split where the classes divide, are gathered
before the loss.
"""
from __future__ import annotations

from typing import Any, Sequence

import torch
import torch.nn.functional as F

from repro_torch.core.taps import Ctx
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.losses import per_sample_xent
from repro_torch.nn.conv import Conv2d, global_avg_pool, max_pool2d
from repro_torch.nn.module import Dense, GroupNorm
from repro_torch.parallel.reshard import whole_cols

VGG_PLANS = {
    "vgg11": (64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"),
    "vgg13": (64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"),
    "vgg16": (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
              512, 512, 512, "M", 512, 512, 512, "M"),
    "vgg19": (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
              512, 512, 512, 512, "M", 512, 512, 512, 512, "M"),
}


def _loss(logits: torch.Tensor, batch: dict) -> torch.Tensor:
    return per_sample_xent(logits[:, None, :], batch["label"][:, None], batch.get("mask"))


def head_logits(head: Dense, params, h: torch.Tensor, ctx: Ctx) -> torch.Tensor:
    """The classifier on pooled features (B, d): (B, classes) logits, all
    classes (gathered where the model axis split them)."""
    return whole_cols(head(params, h[:, None, :], ctx.scope("head"))[:, 0], head.d_out)


class VGG:
    def __init__(self, plan: str = "vgg11", *, n_classes: int = 10, in_ch: int = 3,
                 groups: int = 16, dtype=torch.float32, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.plan = VGG_PLANS[plan]
        self.n_classes = n_classes
        self.dtype = dtype
        self.convs: list[Any] = []
        self.norms: list[GroupNorm] = []
        ch = in_ch
        for i, item in enumerate(self.plan):
            if item == "M":
                self.convs.append("M")
                continue
            self.convs.append(Conv2d(f"conv{i}", ch, item, (3, 3), padding="SAME",
                                     dtype=dtype, device=self.device))
            self.norms.append(GroupNorm(f"gn{i}", item, groups=min(groups, item),
                                        dtype=dtype, device=self.device))
            ch = item
        self.head = Dense("head", ch, n_classes, dtype=dtype, device=self.device)
        self.conv_weights = tuple(c.weight_path for c in self.convs if c != "M")

    def init(self, generator: torch.Generator) -> dict:
        params: dict[str, Any] = {}
        ni = 0
        for i, c in enumerate(self.convs):
            if c == "M":
                continue
            params[f"conv{i}"] = c.init(generator)
            params[f"gn{i}"] = self.norms[ni].init(generator)
            ni += 1
        params["head"] = self.head.init(generator)
        return params

    def axes(self) -> dict:
        out: dict[str, Any] = {}
        ni = 0
        for i, c in enumerate(self.convs):
            if c == "M":
                continue
            out[f"conv{i}"] = c.axes()
            out[f"gn{i}"] = self.norms[ni].axes()
            ni += 1
        out["head"] = self.head.axes()
        return out

    def features(self, params, x, ctx: Ctx) -> torch.Tensor:
        ni = 0
        for i, c in enumerate(self.convs):
            if c == "M":
                x = max_pool2d(x)
                continue
            x = c(params[f"conv{i}"], x, ctx.scope(f"conv{i}"))
            x = F.relu(self.norms[ni](params[f"gn{i}"], x, ctx.scope(f"gn{i}")))
            ni += 1
        return global_avg_pool(x)

    def logits(self, params, x, ctx: Ctx) -> torch.Tensor:
        return head_logits(self.head, params["head"], self.features(params, x, ctx), ctx)

    def loss_with_ctx(self, params, batch, ctx: Ctx) -> torch.Tensor:
        return _loss(self.logits(params, batch["image"], ctx), batch)


class ResNet:
    """Pre-activation basic-block ResNet (18/34-style) with GroupNorm."""

    def __init__(self, blocks_per_stage: Sequence[int] = (2, 2, 2, 2), *,
                 width: int = 64, n_classes: int = 10, in_ch: int = 3,
                 dtype=torch.float32, device: DeviceLike = None):
        self.device = dev = resolve_device(device)
        self.bps = tuple(blocks_per_stage)
        self.width = width
        self.n_classes = n_classes
        self.dtype = dtype
        self.stem = Conv2d("stem", in_ch, width, (3, 3), padding="SAME", dtype=dtype, device=dev)
        self.units = []  # (name, conv1, gn1, conv2, gn2, proj|None)
        ch = width
        for s, n in enumerate(self.bps):
            out = width * (2**s)
            for b in range(n):
                stride = 2 if (s > 0 and b == 0) else 1
                name = f"s{s}b{b}"
                conv1 = Conv2d(f"{name}.c1", ch, out, (3, 3), strides=(stride, stride),
                               padding="SAME", dtype=dtype, device=dev)
                gn1 = GroupNorm(f"{name}.g1", ch, groups=min(16, ch), dtype=dtype, device=dev)
                conv2 = Conv2d(f"{name}.c2", out, out, (3, 3), padding="SAME",
                               dtype=dtype, device=dev)
                gn2 = GroupNorm(f"{name}.g2", out, groups=min(16, out), dtype=dtype, device=dev)
                proj = None
                if stride != 1 or ch != out:
                    proj = Conv2d(f"{name}.proj", ch, out, (1, 1), strides=(stride, stride),
                                  padding="SAME", use_bias=False, dtype=dtype, device=dev)
                self.units.append((name, conv1, gn1, conv2, gn2, proj))
                ch = out
        self.final_gn = GroupNorm("final_gn", ch, groups=16, dtype=dtype, device=dev)
        self.head = Dense("head", ch, n_classes, dtype=dtype, device=dev)
        convs = [self.stem]
        for _, c1, _, c2, _, proj in self.units:
            convs += [c1, c2] + ([proj] if proj is not None else [])
        self.conv_weights = tuple(c.weight_path for c in convs)

    def init(self, generator: torch.Generator) -> dict:
        params: dict[str, Any] = {"stem": self.stem.init(generator)}
        for name, c1, g1, c2, g2, proj in self.units:
            params[name] = {
                "g1": g1.init(generator), "c1": c1.init(generator),
                "g2": g2.init(generator), "c2": c2.init(generator),
            }
            if proj is not None:
                params[name]["proj"] = proj.init(generator)
        params["final_gn"] = self.final_gn.init(generator)
        params["head"] = self.head.init(generator)
        return params

    def axes(self) -> dict:
        out: dict[str, Any] = {"stem": self.stem.axes()}
        for name, c1, g1, c2, g2, proj in self.units:
            out[name] = {"g1": g1.axes(), "c1": c1.axes(), "g2": g2.axes(), "c2": c2.axes()}
            if proj is not None:
                out[name]["proj"] = proj.axes()
        out["final_gn"] = self.final_gn.axes()
        out["head"] = self.head.axes()
        return out

    def logits(self, params, x, ctx: Ctx) -> torch.Tensor:
        x = self.stem(params["stem"], x, ctx.scope("stem"))
        for name, c1, g1, c2, g2, proj in self.units:
            p = params[name]
            sub = ctx.scope(name)
            h = F.relu(g1(p["g1"], x, sub.scope("g1")))
            shortcut = proj(p["proj"], h, sub.scope("proj")) if proj is not None else x
            h = c1(p["c1"], h, sub.scope("c1"))
            h = c2(p["c2"], F.relu(g2(p["g2"], h, sub.scope("g2"))), sub.scope("c2"))
            x = shortcut + h
        x = F.relu(self.final_gn(params["final_gn"], x, ctx.scope("final_gn")))
        return head_logits(self.head, params["head"], global_avg_pool(x), ctx)

    def loss_with_ctx(self, params, batch, ctx: Ctx) -> torch.Tensor:
        return _loss(self.logits(params, batch["image"], ctx), batch)
