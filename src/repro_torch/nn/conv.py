"""Convolution layers with DP taps (port of ``nn/conv.py``).

Activations are channels-last (B, H, W, C) at every module boundary, as in
the JAX package; ``Conv2d`` hands cuDNN a permuted view (NCHW shape,
channels-last memory) and keeps its weight as torch's OIHW
(d_out, d_in, kh, kw).

``Conv2d`` records its *raw* input plus unfold metadata; the clipping engine
unfolds lazily (``unfold2d``) only on the branch that needs the patches.

``SAME`` padding follows XLA: for stride 2 on an even input the padding is
(0, 1), not torch's symmetric (1, 1), so it is computed per dim and applied
the same way by the conv and by ``unfold2d``.

On a model axis (``reshard.model_dim``) ``Conv2d`` is column-parallel on
its output channels, as the JAX package's ``(None, None, "embed", "mlp")``
placement puts them: ``copy_to_model`` on the whole input (each rank's part
of its gradient is summed), this rank's ``p / model`` channels computed and
tapped (``TapMeta.local``: the full ``D`` and ``p`` kept, the norm this
rank's part, the split bias counted on every rank), then all channels
gathered (``reshard.whole_cols``, whose backward hands the tap a contiguous
NHWC slice of the cotangent), so GroupNorm, pooling, the next conv, a
residual add or a ViT's stream see the whole activation.  ``DepthwiseConv1d``
splits its channels with its input (Mamba's column-parallel ``in_x``): a
per-channel op needs no collective.

``DepthwiseConv1d`` is the causal depthwise conv of the Mamba and xLSTM
blocks, with its weight in the JAX layout (k, d) (so ``interop`` copies it
unchanged: it is no ``Conv2d`` weight) and a ``dw_conv`` tap.  Its window
``(B, T, k, d)`` is a strided view of the left-padded input, where the
JAX package stacks k shifted copies: the tap records the view, so a probe
keeps the (B, T + k - 1, d) input alive, not k copies of it.
"""
from __future__ import annotations

import math
from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch.core.taps import ConvInfo, Ctx
from repro_torch.parallel import collectives, reshard
from repro_torch.parallel.reshard import reshard_param
from repro_torch.nn.module import AxesTree, Module, Params, normal_init


def same_padding(size: int, k: int, stride: int, dilation: int = 1) -> tuple[int, int]:
    """XLA's SAME padding (lo, hi) for one spatial dim."""
    out = -(-size // stride)
    eff_k = (k - 1) * dilation + 1
    total = max((out - 1) * stride + eff_k - size, 0)
    return total // 2, total - total // 2


def conv_padding(padding: Any, spatial, kernel, strides) -> tuple[tuple[int, int], ...]:
    """Explicit ((lo, hi), ...) per spatial dim for "SAME" / "VALID" / pairs."""
    if padding == "SAME":
        return tuple(same_padding(n, k, s) for n, k, s in zip(spatial, kernel, strides))
    if padding == "VALID":
        return tuple((0, 0) for _ in spatial)
    return tuple((int(lo), int(hi)) for lo, hi in padding)


def pad_nchw(x: torch.Tensor, pads: tuple[tuple[int, int], ...]) -> torch.Tensor:
    (hl, hh), (wl, wh) = pads
    if hl == hh == wl == wh == 0:
        return x
    return F.pad(x, (wl, wh, hl, hh))


def unfold2d(x: torch.Tensor, info: ConvInfo) -> torch.Tensor:
    """U(a): (B, H, W, d) -> (B, H_out*W_out, d*kh*kw).

    Feature order is channel-major (c * kh*kw + i * kw + j), as XLA's
    ``conv_general_dilated_patches``; the OIHW weight of a (p, d, kh, kw)
    conv flattens to (p, D) in the same order.
    """
    pads = conv_padding(info.padding, x.shape[1:3], info.kernel, info.strides)
    xp = pad_nchw(x.permute(0, 3, 1, 2), pads)
    patches = F.unfold(xp, info.kernel, stride=info.strides)
    return patches.transpose(1, 2)  # (B, L, D)


class Conv2d(Module):
    """Channels-last conv with a DP "matmul" tap (T = H_out*W_out, D = d*kh*kw)."""

    def __init__(
        self, name: str, d_in: int, d_out: int, kernel: tuple[int, int], *,
        strides: tuple[int, int] = (1, 1), padding="SAME", use_bias: bool = True,
        dtype=torch.float32, param_dtype=torch.float32, device: torch.device,
    ):
        self.name = name
        self.d_in = d_in
        self.d_out = d_out
        self.kernel = tuple(kernel)
        self.strides = tuple(strides)
        self.padding = padding
        self.use_bias = use_bias
        self.dtype = dtype
        self.param_dtype = param_dtype
        self.device = device

    @property
    def weight_path(self) -> str:
        """The weight's path in the model's parameters (``a.b`` -> ``a/b/w``)."""
        return self.name.replace(".", "/") + "/w"

    def init(self, generator: torch.Generator) -> Params:
        fan_in = self.d_in * math.prod(self.kernel)
        p = {
            "w": normal_init(
                generator, (self.d_out, self.d_in, *self.kernel),
                1.0 / math.sqrt(fan_in), self.param_dtype, self.device,
            )
        }
        if self.use_bias:
            p["b"] = torch.zeros((self.d_out,), dtype=self.param_dtype, device=self.device)
        return p

    # the JAX package's HWIO (None, None, "embed", "mlp") in this OIHW layout
    W_AXES = ("mlp", "embed", None, None)

    def axes(self) -> AxesTree:
        a = {"w": self.W_AXES}
        if self.use_bias:
            a["b"] = ("mlp",)
        return a

    def __call__(self, params: Params, x: torch.Tensor, ctx: Ctx) -> torch.Tensor:
        full = (self.d_out, self.d_in, *self.kernel)
        split = reshard.model_dim(self.W_AXES, full)  # 0 (output channels) or None
        w = reshard_param(params["w"].to(self.dtype), self.W_AXES, full)
        x = x.to(self.dtype)
        if split == 0:
            x = collectives.copy_to_model(x, reshard.model_group())
        pads = conv_padding(self.padding, x.shape[1:3], self.kernel, self.strides)
        xc = x.permute(0, 3, 1, 2)
        if all(lo == hi for lo, hi in pads):
            s = F.conv2d(xc, w, stride=self.strides, padding=tuple(lo for lo, _ in pads))
        else:
            s = F.conv2d(pad_nchw(xc, pads), w, stride=self.strides)
        s = s.permute(0, 2, 3, 1)  # back to (B, H_out, W_out, p)
        if self.use_bias:
            s = s + reshard_param(params["b"].to(self.dtype), self.W_AXES[:1], (self.d_out,))
        if ctx.collect:
            s = ctx.tap(
                "out", s, kind="matmul", a=x,  # raw input; the engine unfolds lazily
                T=int(s.shape[1] * s.shape[2]), D=self.d_in * math.prod(self.kernel),
                p=self.d_out, param_path="w", bias_path="b" if self.use_bias else None,
                conv=ConvInfo(kernel=self.kernel, strides=self.strides, padding=self.padding),
                local=None if split is None else (self.d_in * math.prod(self.kernel),
                                                  w.shape[0], 1),
            )
        return reshard.whole_cols(s, self.d_out)


class DepthwiseConv1d(Module):
    """Causal depthwise conv1d: s[b, t, c] = sum_j w[j, c] x[b, t - k + 1 + j, c]
    (+ b[c]), left-padded with zeros or with the carried state, the last
    k - 1 inputs of the previous call (B, k - 1, d)."""

    def __init__(
        self, name: str, d: int, k: int = 4, *, use_bias: bool = True, dtype=torch.float32,
        param_dtype=torch.float32, device: torch.device,
    ):
        self.name = name
        self.d = d
        self.k = k
        self.use_bias = use_bias
        self.dtype = dtype
        self.param_dtype = param_dtype
        self.device = device

    def init(self, generator: torch.Generator) -> Params:
        p = {"w": normal_init(generator, (self.k, self.d), 1.0 / math.sqrt(self.k),
                              self.param_dtype, self.device)}
        if self.use_bias:
            p["b"] = torch.zeros((self.d,), dtype=self.param_dtype, device=self.device)
        return p

    def axes(self) -> AxesTree:
        a = {"w": (None, "mlp")}
        if self.use_bias:
            a["b"] = ("mlp",)
        return a

    def padded(self, x: torch.Tensor, state: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, T + k - 1, d): the carried state (zeros without one), then x."""
        if state is None:
            pad = x.new_zeros((x.shape[0], self.k - 1, x.shape[-1]))
        else:
            pad = state.to(x.dtype)
        return torch.cat([pad, x], dim=1)

    def __call__(self, params: Params, x: torch.Tensor, ctx: Ctx, *,
                 state: Optional[torch.Tensor] = None) -> tuple[torch.Tensor, torch.Tensor]:
        """(y, new state): the state is the last k - 1 rows of the padded
        input, the carried ones included where the call is shorter."""
        split = reshard.model_dim((None, "mlp"), (self.k, self.d))  # 1 (channels) or None
        w = reshard_param(params["w"].to(self.dtype), (None, "mlp"), (self.k, self.d))
        x = x.to(self.dtype)
        xp = self.padded(x, state)
        unf = xp.unfold(1, self.k, 1).transpose(2, 3)  # (B, T, k, d), a view
        s = torch.einsum("btkd,kd->btd", unf, w)
        if self.use_bias:
            s = s + reshard_param(params["b"].to(self.dtype), ("mlp",), (self.d,))
        if ctx.collect:
            s = ctx.tap("out", s, kind="dw_conv", a=unf, T=int(x.shape[1]), D=self.k,
                        p=self.d, param_path="w", bias_path="b" if self.use_bias else None,
                        local=None if split is None else (self.k, w.shape[1], 1))
        return s, xp[:, xp.shape[1] - (self.k - 1):]


def max_pool2d(x: torch.Tensor, window: int = 2, stride: int = 2) -> torch.Tensor:
    """VALID max pooling on (B, H, W, C)."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), window, stride).permute(0, 2, 3, 1)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    return x.mean(dim=(1, 2))
