"""Minimal functional modules with DP taps (port of ``nn/module.py``).

A module is a configuration holder with

- ``init(generator) -> params``   a nested dict of tensors on ``self.device``
- ``__call__(params, x, ctx)``    the forward; ``ctx`` threads the DP taps

Parameters stay plain tensors keyed by the JAX package's paths, so the
clipping engine can map every tap to its parameter leaf by name.  The
JAX package's ``reshard_param`` has no counterpart: one device needs none.
A module keeps its parameters in ``param_dtype`` and computes in ``dtype``
(fp32 parameters under bf16 compute, as the transformer configs declare).
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.core.taps import Ctx

NORM_EPS = 1e-5  # GroupNorm and LayerNorm, as the JAX package's defaults
RMS_EPS = 1e-6  # RMSNorm, as the JAX package's default

Params = Any


class Module:
    """Base class; subclasses are static configuration holders."""

    name: str
    device: torch.device

    def init(self, generator: torch.Generator) -> Params:
        raise NotImplementedError

    def __call__(self, params: Params, x: torch.Tensor, ctx: Ctx):
        raise NotImplementedError


def normal_init(
    generator: torch.Generator, shape, scale: float, dtype, device: torch.device
) -> torch.Tensor:
    x = torch.randn(tuple(shape), generator=generator, device=device, dtype=torch.float32)
    return (scale * x).to(dtype)


class Dense(Module):
    """y = x @ W + b with a DP tap on the pre-activation.

    ``W`` keeps the JAX layout (d_in, d_out).  ``x``: (B, ..., d_in); the
    middle dims are positions T and the recorded activation is (B, T, d_in).
    """

    def __init__(
        self, name: str, d_in: int, d_out: int, *, use_bias: bool = True,
        dtype=torch.float32, param_dtype=torch.float32, device: torch.device,
    ):
        self.name = name
        self.d_in = d_in
        self.d_out = d_out
        self.use_bias = use_bias
        self.dtype = dtype
        self.param_dtype = param_dtype
        self.device = device

    def init(self, generator: torch.Generator) -> Params:
        p = {"w": normal_init(
            generator, (self.d_in, self.d_out), 1.0 / math.sqrt(self.d_in), self.param_dtype,
            self.device,
        )}
        if self.use_bias:
            p["b"] = torch.zeros((self.d_out,), dtype=self.param_dtype, device=self.device)
        return p

    def __call__(self, params: Params, x: torch.Tensor, ctx: Ctx) -> torch.Tensor:
        x = x.to(self.dtype)
        s = x @ params["w"].to(self.dtype)
        if self.use_bias:
            s = s + params["b"].to(self.dtype)
        if ctx.collect:
            batch = x.shape[0]
            t = int(math.prod(x.shape[1:-1])) if x.ndim > 2 else 1
            s = ctx.tap(
                "out", s, kind="matmul", a=x.reshape(batch, t, self.d_in),
                T=t, D=self.d_in, p=self.d_out, param_path="w",
                bias_path="b" if self.use_bias else None,
            )
        return s


class GroupNorm(Module):
    """GroupNorm on channels-last input (the paper swaps BatchNorm for
    GroupNorm: batch statistics mix samples and are not DP-safe).

    ``x_hat`` is computed explicitly because the "scale" tap records it;
    ``F.group_norm`` with its affine parameters would hide it.
    """

    def __init__(
        self, name: str, d: int, *, groups: int = 16, dtype=torch.float32,
        device: torch.device,
    ):
        if d % groups != 0:
            raise ValueError(f"GroupNorm {name}: {d} channels not divisible by {groups} groups")
        self.name = name
        self.d = d
        self.groups = groups
        self.dtype = dtype
        self.device = device

    def init(self, generator: torch.Generator) -> Params:
        del generator
        return {
            "g": torch.ones((self.d,), dtype=self.dtype, device=self.device),
            "b": torch.zeros((self.d,), dtype=self.dtype, device=self.device),
        }

    def __call__(self, params: Params, x: torch.Tensor, ctx: Ctx) -> torch.Tensor:
        # x: (B, *spatial, d)
        batch = x.shape[0]
        # statistics in fp32 at least (fp64 compute keeps fp64)
        xf = x.to(torch.promote_types(x.dtype, torch.float32)).reshape(
            batch, -1, self.groups, self.d // self.groups)
        mu = xf.mean(dim=(1, 3), keepdim=True)
        var = (xf - mu).square().mean(dim=(1, 3), keepdim=True)
        x_hat = ((xf - mu) * torch.rsqrt(var + NORM_EPS)).reshape(x.shape).to(self.dtype)
        s = x_hat * params["g"].to(self.dtype) + params["b"].to(self.dtype)
        if ctx.collect:
            t = int(math.prod(x.shape[1:-1]))
            s = ctx.tap(
                "out", s, kind="scale", a=x_hat.reshape(batch, t, self.d),
                T=t, D=self.d, p=self.d, param_path="g", bias_path="b",
            )
        return s


class Embedding(Module):
    """Table lookup with the index-equality ghost-norm tap (kind "embedding").

    The recorded activation is the integer ids (B, T) themselves: autograd
    saves integer tensors, so the JAX package's fp32 id channel has no
    counterpart here.
    """

    def __init__(
        self, name: str, vocab: int, d: int, *, dtype=torch.float32,
        param_dtype=torch.float32, device: torch.device,
    ):
        self.name = name
        self.vocab = vocab
        self.d = d
        self.dtype = dtype
        self.param_dtype = param_dtype
        self.device = device

    def init(self, generator: torch.Generator) -> Params:
        return {"e": normal_init(
            generator, (self.vocab, self.d), 0.02, self.param_dtype, self.device
        )}

    def __call__(self, params: Params, ids: torch.Tensor, ctx: Ctx) -> torch.Tensor:
        s = F.embedding(ids, params["e"].to(self.dtype))
        if ctx.collect:
            batch, t = ids.shape[0], int(math.prod(ids.shape[1:]))
            s = ctx.tap(
                "out", s, kind="embedding", a=ids.reshape(batch, t),
                T=t, D=self.vocab, p=self.d, param_path="e",
            )
        return s


class LayerNorm(Module):
    """LayerNorm (scale and bias) with a DP "scale" tap.

    Statistics in fp32; ``x_hat`` is cast to the compute dtype and recorded.
    """

    def __init__(
        self, name: str, d: int, *, dtype=torch.float32, param_dtype=torch.float32,
        device: torch.device,
    ):
        self.name = name
        self.d = d
        self.dtype = dtype
        self.param_dtype = param_dtype
        self.device = device

    def init(self, generator: torch.Generator) -> Params:
        del generator
        return {
            "g": torch.ones((self.d,), dtype=self.param_dtype, device=self.device),
            "b": torch.zeros((self.d,), dtype=self.param_dtype, device=self.device),
        }

    def __call__(self, params: Params, x: torch.Tensor, ctx: Ctx) -> torch.Tensor:
        xf = x.float()
        mu = xf.mean(dim=-1, keepdim=True)
        var = (xf - mu).square().mean(dim=-1, keepdim=True)
        x_hat = ((xf - mu) * torch.rsqrt(var + NORM_EPS)).to(self.dtype)
        s = x_hat * params["g"].to(self.dtype) + params["b"].to(self.dtype)
        if ctx.collect:
            batch = x.shape[0]
            t = int(math.prod(x.shape[1:-1])) if x.ndim > 2 else 1
            s = ctx.tap(
                "out", s, kind="scale", a=x_hat.reshape(batch, t, self.d),
                T=t, D=self.d, p=self.d, param_path="g", bias_path="b",
            )
        return s


class RMSNorm(Module):
    """RMSNorm with a DP "scale" tap on the gain product.

    ``x_hat`` in fp32, cast to the compute dtype, *then* multiplied by the
    gain cast to the compute dtype, in the JAX package's order (the order
    decides the bf16 rounding).
    """

    def __init__(
        self, name: str, d: int, *, eps: float = RMS_EPS, dtype=torch.float32,
        param_dtype=torch.float32, device: torch.device,
    ):
        self.name = name
        self.d = d
        self.eps = eps
        self.dtype = dtype
        self.param_dtype = param_dtype
        self.device = device

    def init(self, generator: torch.Generator) -> Params:
        del generator
        return {"g": torch.ones((self.d,), dtype=self.param_dtype, device=self.device)}

    def __call__(self, params: Params, x: torch.Tensor, ctx: Ctx) -> torch.Tensor:
        xf = x.float()
        x_hat = (xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + self.eps)).to(self.dtype)
        s = x_hat * params["g"].to(self.dtype)
        if ctx.collect:
            batch = x.shape[0]
            t = int(math.prod(x.shape[1:-1])) if x.ndim > 2 else 1
            s = ctx.tap(
                "out", s, kind="scale", a=x_hat.reshape(batch, t, self.d),
                T=t, D=self.d, p=self.d, param_path="g",
            )
        return s
