"""Layer stacking (port of ``nn/stack.py``'s ``ScannedStack``).

``n`` copies of one block over stacked parameters: every leaf is (L, ...)
exactly as in the JAX tree, so ``interop.params_from_jax`` copies it
unchanged.  Where the JAX package scans, this is a Python loop over the
layers; each layer runs under ``ctx.layer(l, n)``, so its taps record the
meta once per name with a leading stack dim and bank under their own
``(name, layer)`` key.  The leaves are split with one ``unbind`` per
forward, whose backward stacks the per-layer gradients into one (L, ...)
tensor.

The JAX package rematerialises each layer in the backward (``cfg.remat``);
this port keeps every layer's activations instead, so its peak memory
differs by design.
"""
from __future__ import annotations

import torch

from repro_torch.core.taps import Ctx
from repro_torch.nn.module import Module, Params
from repro_torch.utils.tree import flatten_dict, unflatten_dict


class ScannedStack(Module):
    """``n`` copies of ``block`` applied in order over stacked params."""

    def __init__(self, name: str, block: Module, n: int):
        self.name = name
        self.block = block
        self.n = n

    def init(self, generator: torch.Generator) -> Params:
        layers = [flatten_dict(self.block.init(generator)) for _ in range(self.n)]
        return unflatten_dict({k: torch.stack([p[k] for p in layers]) for k in layers[0]})

    def __call__(self, params: Params, x: torch.Tensor, ctx: Ctx) -> torch.Tensor:
        flat = flatten_dict(params)
        per_layer = zip(*(leaf.unbind(0) for leaf in flat.values()))
        for index, leaves in enumerate(per_layer):
            x = self.block(unflatten_dict(dict(zip(flat, leaves))), x, ctx.layer(index, self.n))
        return x
