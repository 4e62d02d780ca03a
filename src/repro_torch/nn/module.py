"""Minimal functional modules with DP taps (port of ``nn/module.py``).

A module is a configuration holder with

- ``init(generator) -> params``   a nested dict of tensors on ``self.device``
- ``__call__(params, x, ctx)``    the forward; ``ctx`` threads the DP taps

- ``axes() -> axes_tree``        the logical sharding axes mirroring ``init``

Parameters stay plain tensors keyed by the JAX package's paths, so the
clipping engine can map every tap to its parameter leaf by name.  The
logical axis names are the JAX package's; ``repro_torch.parallel.sharding``
resolves them to mesh axes.  Where a weight is used, ``reshard_param``
gathers the dims a sharded train state stores over the data axis (a no-op
on one process), after the cast to the compute dtype.  A module keeps its
parameters in ``param_dtype`` and computes in ``dtype`` (fp32 parameters
under bf16 compute, as the transformer configs declare).

On a model axis (``reshard.model_dim``) ``Dense`` runs Megatron's two
forms: column-parallel (its output dim on "model": ``copy_to_model`` on
the input, the output this rank's columns) and row-parallel (its input
dim on "model": the input arrives as this rank's columns, and
``reduce_from_model`` sums the partial products; a bias is whole and is
added once, after the sum).  ``Embedding`` runs vocab-parallel (its rows
on "model": ids outside this rank's ``[lo, hi)`` give zero rows, then
``reduce_from_model``).  Their taps record this rank's ``a`` and ``g``
with the full ``D`` and ``p`` (``TapMeta.local``).  ``RMSNorm`` given this
rank's channels of a split input (Mamba's ``d_inner``) sums the squares
over the model axis (``collectives.sum_parts``) and scales by its slice of
the whole gain (``reshard.slice_whole``): a split tap.  ``GroupNorm`` and
``LayerNorm`` always see whole channels (a split convolution gathers its
output).
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.core.taps import Ctx
from repro_torch.parallel import collectives, reshard
from repro_torch.parallel.reshard import reshard_param

NORM_EPS = 1e-5  # GroupNorm and LayerNorm, as the JAX package's defaults
RMS_EPS = 1e-6  # RMSNorm, as the JAX package's default

Params = Any
AxesTree = Any


class Module:
    """Base class; subclasses are static configuration holders."""

    name: str
    device: torch.device

    def init(self, generator: torch.Generator) -> Params:
        raise NotImplementedError

    def axes(self) -> AxesTree:
        raise NotImplementedError

    def __call__(self, params: Params, x: torch.Tensor, ctx: Ctx):
        raise NotImplementedError


def at_least_fp32(x: torch.Tensor) -> torch.Tensor:
    """``x`` in fp32, or in its own dtype where that is wider (fp64 compute
    keeps fp64)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


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
        w_axes: tuple = ("embed", "mlp"), dtype=torch.float32, param_dtype=torch.float32,
        device: torch.device,
    ):
        self.name = name
        self.d_in = d_in
        self.d_out = d_out
        self.use_bias = use_bias
        self.w_axes = w_axes
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

    def axes(self) -> AxesTree:
        a = {"w": self.w_axes}
        if self.use_bias:
            a["b"] = (self.w_axes[-1],)
        return a

    def __call__(self, params: Params, x: torch.Tensor, ctx: Ctx) -> torch.Tensor:
        split = reshard.model_dim(self.w_axes, (self.d_in, self.d_out))
        w = reshard_param(params["w"].to(self.dtype), self.w_axes, (self.d_in, self.d_out))
        x = x.to(self.dtype)
        if split == 0 and x.shape[-1] != w.shape[0]:
            raise ValueError(f"{self.name}: a row-parallel input of {x.shape[-1]} columns, "
                             f"this rank's slice is {w.shape[0]} of {self.d_in}")
        s = (collectives.copy_to_model(x, reshard.model_group()) if split == 1 else x) @ w
        b = None
        if self.use_bias:
            b = reshard_param(params["b"].to(self.dtype), self.w_axes[-1:], (self.d_out,))
            if split != 0:
                s = s + b
        if ctx.collect:
            batch = x.shape[0]
            t = int(math.prod(x.shape[1:-1])) if x.ndim > 2 else 1
            s = ctx.tap(
                "out", s, kind="matmul", a=x.reshape(batch, t, x.shape[-1]),
                T=t, D=self.d_in, p=self.d_out, param_path="w",
                bias_path="b" if self.use_bias else None,
                local=None if split is None else (w.shape[0], w.shape[1], 1),
            )
        if split == 0:  # the partial products summed, then the whole bias
            s = collectives.reduce_from_model(s, reshard.model_group())
            if b is not None:
                s = s + b
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

    def axes(self) -> AxesTree:
        return {"g": (None,), "b": (None,)}

    def __call__(self, params: Params, x: torch.Tensor, ctx: Ctx) -> torch.Tensor:
        # x: (B, *spatial, d)
        batch = x.shape[0]
        # statistics in fp32 at least (fp64 compute keeps fp64)
        xf = at_least_fp32(x).reshape(batch, -1, self.groups, self.d // self.groups)
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
        self, name: str, vocab: int, d: int, *, axes_: tuple = ("vocab", "embed"),
        dtype=torch.float32, param_dtype=torch.float32, device: torch.device,
    ):
        self.name = name
        self.vocab = vocab
        self.d = d
        self.axes_ = axes_
        self.dtype = dtype
        self.param_dtype = param_dtype
        self.device = device

    def init(self, generator: torch.Generator) -> Params:
        return {"e": normal_init(
            generator, (self.vocab, self.d), 0.02, self.param_dtype, self.device
        )}

    def axes(self) -> AxesTree:
        return {"e": self.axes_}

    def __call__(self, params: Params, ids: torch.Tensor, ctx: Ctx) -> torch.Tensor:
        split = reshard.model_dim(self.axes_, (self.vocab, self.d))  # rows ("vocab") or None
        e = reshard_param(params["e"].to(self.dtype), self.axes_, (self.vocab, self.d))
        if split == 0:  # this rank's rows [lo, lo + rows): the others' ids read row 0
            rows = e.shape[0]
            local = ids - reshard.model_coord() * rows
            mine = (local >= 0) & (local < rows)
            ids = torch.where(mine, local, torch.zeros_like(local))
        s = F.embedding(ids, e)
        if ctx.collect:
            batch, t = ids.shape[0], int(math.prod(ids.shape[1:]))
            s = ctx.tap(
                "out", s, kind="embedding", a=ids.reshape(batch, t),
                T=t, D=self.vocab, p=self.d, param_path="e",
                local=None if split is None else (e.shape[0], self.d, 1),
            )
        if split == 0:  # zero rows (and tap cotangents) for the others' ids
            s = collectives.reduce_from_model(s * mine[..., None].to(s.dtype),
                                              reshard.model_group())
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

    def axes(self) -> AxesTree:
        return {"g": (None,), "b": (None,)}

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

    ``x_hat`` in fp32 (fp64 under fp64 compute), cast to the compute dtype,
    *then* multiplied by the gain cast to the compute dtype, in the JAX
    package's order (the order decides the bf16 rounding).
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

    def axes(self) -> AxesTree:
        return {"g": (None,)}

    def __call__(self, params: Params, x: torch.Tensor, ctx: Ctx) -> torch.Tensor:
        xf = at_least_fp32(x)
        d = x.shape[-1]
        g = params["g"]
        if d != self.d:  # this rank's channels of a split input: the squares summed over all
            if d * reshard.model_size() != self.d:
                raise ValueError(f"{self.name}: {d} of {self.d} channels on a model axis of "
                                 f"{reshard.model_size()}")
            group = reshard.model_group()
            ms = collectives.sum_parts(xf.square().sum(dim=-1, keepdim=True), group) / self.d
            g = reshard.slice_whole(g)
        else:
            ms = xf.square().mean(dim=-1, keepdim=True)
        x_hat = (xf * torch.rsqrt(ms + self.eps)).to(self.dtype)
        s = x_hat * g.to(self.dtype)
        if ctx.collect:
            batch = x.shape[0]
            t = int(math.prod(x.shape[1:-1])) if x.ndim > 2 else 1
            s = ctx.tap(
                "out", s, kind="scale", a=x_hat.reshape(batch, t, d),
                T=t, D=self.d, p=self.d, param_path="g",
                local=None if d == self.d else (d, d, 1),
            )
        return s
