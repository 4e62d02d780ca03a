"""The plain transformer feed-forward block (port of ``nn/mlp.py``'s ``MLP``).

``jax.nn.gelu`` defaults to the tanh approximation, so this uses
``F.gelu(approximate="tanh")``: the exact erf form would not match the
JAX package.  The gated (SwiGLU) block comes with the LM slice.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.taps import Ctx
from repro_torch.nn.module import Dense, Module, Params


class MLP(Module):
    """wo(gelu(wi(x))), both projections with a bias and a DP tap."""

    def __init__(
        self, name: str, d_model: int, d_ff: int, *, dtype=torch.float32,
        param_dtype=torch.float32, device: torch.device,
    ):
        self.name = name
        common = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.wi = Dense(f"{name}.wi", d_model, d_ff, **common)
        self.wo = Dense(f"{name}.wo", d_ff, d_model, **common)

    def init(self, generator: torch.Generator) -> Params:
        return {"wi": self.wi.init(generator), "wo": self.wo.init(generator)}

    def __call__(self, params: Params, x: torch.Tensor, ctx: Ctx) -> torch.Tensor:
        h = F.gelu(self.wi(params["wi"], x, ctx.scope("wi")), approximate="tanh")
        return self.wo(params["wo"], h, ctx.scope("wo"))
