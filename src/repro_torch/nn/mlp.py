"""Transformer feed-forward blocks (port of ``nn/mlp.py``): gated (SwiGLU)
and plain (GELU).

``jax.nn.gelu`` defaults to the tanh approximation, so ``MLP`` uses
``F.gelu(approximate="tanh")``: the exact erf form would not match the
JAX package.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.taps import Ctx
from repro_torch.nn.module import AxesTree, Dense, Module, Params


class MLP(Module):
    """wo(gelu(wi(x))), both projections with a bias and a DP tap."""

    def __init__(
        self, name: str, d_model: int, d_ff: int, *, dtype=torch.float32,
        param_dtype=torch.float32, device: torch.device,
    ):
        self.name = name
        common = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.wi = Dense(f"{name}.wi", d_model, d_ff, w_axes=("embed", "mlp"), **common)
        self.wo = Dense(f"{name}.wo", d_ff, d_model, w_axes=("mlp", "embed"), **common)

    def init(self, generator: torch.Generator) -> Params:
        return {"wi": self.wi.init(generator), "wo": self.wo.init(generator)}

    def axes(self) -> AxesTree:
        return {"wi": self.wi.axes(), "wo": self.wo.axes()}

    def __call__(self, params: Params, x: torch.Tensor, ctx: Ctx) -> torch.Tensor:
        h = F.gelu(self.wi(params["wi"], x, ctx.scope("wi")), approximate="tanh")
        return self.wo(params["wo"], h, ctx.scope("wo"))


class GatedMLP(Module):
    """SwiGLU: wo(silu(wg(x)) * wu(x)), three separate Dense without bias."""

    def __init__(
        self, name: str, d_model: int, d_ff: int, *, dtype=torch.float32,
        param_dtype=torch.float32, device: torch.device,
    ):
        self.name = name
        common = dict(use_bias=False, dtype=dtype, param_dtype=param_dtype, device=device)
        self.wg = Dense(f"{name}.wg", d_model, d_ff, w_axes=("embed", "mlp"), **common)
        self.wu = Dense(f"{name}.wu", d_model, d_ff, w_axes=("embed", "mlp"), **common)
        self.wo = Dense(f"{name}.wo", d_ff, d_model, w_axes=("mlp", "embed"), **common)

    def init(self, generator: torch.Generator) -> Params:
        return {"wg": self.wg.init(generator), "wu": self.wu.init(generator),
                "wo": self.wo.init(generator)}

    def axes(self) -> AxesTree:
        return {"wg": self.wg.axes(), "wu": self.wu.axes(), "wo": self.wo.axes()}

    def __call__(self, params: Params, x: torch.Tensor, ctx: Ctx) -> torch.Tensor:
        gate = self.wg(params["wg"], x, ctx.scope("wg"))
        up = self.wu(params["wu"], x, ctx.scope("wu"))
        return self.wo(params["wo"], F.silu(gate) * up, ctx.scope("wo"))
