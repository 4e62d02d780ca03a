"""Layer stacking (port of ``nn/stack.py``'s ``ScannedStack``).

``n`` copies of one block over stacked parameters: every leaf is (L, ...)
exactly as in the JAX tree, so ``interop.params_from_jax`` copies it
unchanged.  Where the JAX package scans, this is a Python loop over the
layers; each layer runs under ``ctx.layer(l, n)``, so its taps record the
meta once per name with a leading stack dim and keep their per-layer
tensors under their own ``(name, layer)`` key: the fused probes' banks, or
under the explicit engine the activation and the pre-activation.  The
leaves are split with one ``unbind`` per forward, whose backward stacks the
per-layer gradients into one (L, ...) tensor; under ``torch.func`` (the
vmap oracle) the parameters are not batched and the split is the same.

A serving cache is stacked the same way: every cache leaf is (L, B, ...),
and layer ``l`` reads and writes its slice ``[l]`` (a view), so a block
that updates its cache in place updates the stacked tree.

The JAX package rematerialises each layer in the backward (``cfg.remat``);
this port keeps every layer's activations instead, so its peak memory
differs by design.
"""
from __future__ import annotations

from typing import Any, Optional

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
        """Layer by layer into preallocated (L, ...) leaves: the same draws in
        the same order as stacking a list, with one layer's transient."""
        first = flatten_dict(self.block.init(generator))
        out = {k: torch.empty((self.n, *v.shape), dtype=v.dtype, device=v.device)
               for k, v in first.items()}
        for index in range(self.n):
            layer = first if index == 0 else flatten_dict(self.block.init(generator))
            for k, v in layer.items():
                out[k][index] = v
            del layer
        return unflatten_dict(out)

    def init_cache(self, batch: int, dtype: torch.dtype, **kw) -> Any:
        """The block's cache with a leading layer dim: every leaf (L, B, ...)."""
        one = flatten_dict(self.block.init_cache(batch, dtype, **kw))
        return unflatten_dict({
            k: v.unsqueeze(0).repeat(self.n, *([1] * v.ndim)) for k, v in one.items()
        })

    def __call__(
        self, params: Params, x: torch.Tensor, ctx: Ctx, *,
        cache: Optional[dict] = None, **kw,
    ):
        """Without ``cache`` (training) returns x; with it, (x, cache): the
        blocks write their new cache rows into ``cache`` in place."""
        flat = flatten_dict(params)
        per_layer = zip(*(leaf.unbind(0) for leaf in flat.values()))
        if cache is None:
            for index, leaves in enumerate(per_layer):
                x = self.block(unflatten_dict(dict(zip(flat, leaves))), x,
                               ctx.layer(index, self.n), **kw)
            return x
        flat_cache = flatten_dict(cache)
        for index, leaves in enumerate(per_layer):
            layer_cache = unflatten_dict({k: v[index] for k, v in flat_cache.items()})
            x, _ = self.block(unflatten_dict(dict(zip(flat, leaves))), x,
                              ctx.layer(index, self.n), cache=layer_cache, **kw)
        return x, cache
