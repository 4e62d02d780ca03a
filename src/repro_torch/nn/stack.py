"""Layer stacking (port of ``nn/stack.py``: ``ScannedStack`` and
``SequentialBlocks``).

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

Rematerialisation (``remat=True``, the JAX package's ``cfg.remat``):
while autograd records, each layer runs under
``torch.utils.checkpoint.checkpoint(use_reentrant=False)``, which keeps the
layer's input and drops what its ops save; every backward that needs them
runs the layer again.  A step's two backwards over one graph (the
second-backward modes' clipped pass) recompute each layer twice, as the
JAX package's two pullbacks under ``jax.checkpoint`` do.  The recomputed
forward calls the same taps: ``Ctx.tap`` records the meta, the explicit
engine's activations and the probes' dummy leaves only the first time a
key is seen, so a recomputation leaves the step's records as the first
forward wrote them; the probes themselves run again (their saved input
is what the recomputation restores) and bank only in the backward of the
original graph.  The explicit engine (``*_taps``) keeps every tap's input
and pre-activation outside the recomputed region, as the JAX package keeps
them as scan ys, so remat saves less there (it empties ``zs`` after its
first backward, which the recomputation's closure would otherwise tie to
the graph); so does book-keeping
(``bk_mixed``), whose books keep a ghost-banked tap's activation and
cotangent from the backward to the contraction.  The ``vmap`` oracle runs
its stack without remat (``Ctx.remat`` False), a divergence by design:
``torch.func``'s transforms refuse the saved-tensor hooks that
non-reentrant checkpointing installs, and the function is the same.  The
forward draws no random numbers (no dropout), so the RNG state is not
saved and restored (``preserve_rng_state=False``: it would buy nothing and
costs a device state copy per layer).  Under ``no_grad`` (serving,
discovery) the plain loop runs.

Keyword arguments reach every layer unchanged: ``positions``, the experts'
``dispatch`` and Whisper's ``enc_out``, the encoder states that every
decoder layer's cross-attention reads.  Under remat ``enc_out`` is closed
over by each checkpointed layer, not passed as its input: non-reentrant
checkpointing records the layer's graph as usual (only its saved tensors
are dropped and recomputed), so the gradient reaches the encoder through
every layer's recomputation, the same sums as without remat.  Its cross
k/v taps are recorded once per layer by the first forward, like every
other tap.

Sequence parallelism (a model axis that splits, ``reshard.shard_seq``):
the carry between layers is stored as this rank's T / model slice, so a
checkpointed layer keeps only that slice as its input (the JAX docstring's
"activation-checkpoint residuals ... stored sharded T/model_size");
each layer gathers the whole sequence first (``unshard_seq``), so its taps
and norms see all of it, and the stack hands the whole sequence on.
Serving keeps the whole sequence on every rank; its caches hold each
rank's part of the serve state (``parallel.sharding.local_serve_shardings``),
and the blocks run on them as they are.

``SequentialBlocks`` runs a period of different blocks in order (Jamba's
Mamba and attention layers, xLSTM's sLSTM and mLSTMs), its parameters and
cache keyed by position (``"0"``, ``"1"``, ...) as in the JAX package.  A
``ScannedStack`` of it stacks the period: one stack level, whose remat unit
is the whole period (the JAX package's ``nested_remat``, off by default,
has no counterpart).
"""
from __future__ import annotations

from typing import Any, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.taps import Ctx
from repro_torch.nn.module import AxesTree, Module, Params
from repro_torch.parallel.reshard import shard_seq, unshard_seq
from repro_torch.utils.tree import flatten_dict, unflatten_dict


class SequentialBlocks(Module):
    """Apply ``blocks`` in order; params and cache keyed by position."""

    def __init__(self, name: str, blocks: list[Module]):
        self.name = name
        self.blocks = list(blocks)

    def init(self, generator: torch.Generator) -> Params:
        return {str(i): b.init(generator) for i, b in enumerate(self.blocks)}

    def axes(self) -> AxesTree:
        return {str(i): b.axes() for i, b in enumerate(self.blocks)}

    def init_cache(self, batch: int, dtype: torch.dtype, **kw) -> dict:
        return {str(i): b.init_cache(batch, dtype, **kw) for i, b in enumerate(self.blocks)}

    def __call__(self, params: Params, x: torch.Tensor, ctx: Ctx, *,
                 cache: Optional[dict] = None, **kw):
        """Without ``cache`` returns x; with it, (x, cache), each block
        writing its part of ``cache`` in place."""
        for i, block in enumerate(self.blocks):
            key = str(i)
            if cache is None:
                x = block(params[key], x, ctx.scope(key), **kw)
            else:
                x, _ = block(params[key], x, ctx.scope(key), cache=cache[key], **kw)
        return x if cache is None else (x, cache)


class ScannedStack(Module):
    """``n`` copies of ``block`` applied in order over stacked params."""

    def __init__(self, name: str, block: Module, n: int, *, remat: bool = True):
        self.name = name
        self.block = block
        self.n = n
        self.remat = remat

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

    def axes(self) -> AxesTree:
        """The block's axes with "stack" in front of every leaf."""
        from repro_torch.parallel.sharding import _flat_axes

        return unflatten_dict({k: ("stack",) + tuple(a)
                               for k, a in _flat_axes(self.block.axes()).items()})

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
            remat = self.remat and ctx.remat and torch.is_grad_enabled()
            t = x.shape[1]
            for index, leaves in enumerate(per_layer):
                lctx = ctx.layer(index, self.n)

                def layer(h, *ls, lctx=lctx):
                    h = unshard_seq(h, t)
                    return shard_seq(
                        self.block(unflatten_dict(dict(zip(flat, ls))), h, lctx, **kw))

                if remat:
                    x = checkpoint(layer, x, *leaves, use_reentrant=False,
                                   preserve_rng_state=False)
                else:
                    x = layer(x, *leaves)
            return unshard_seq(x, t)
        flat_cache = flatten_dict(cache)
        for index, leaves in enumerate(per_layer):
            layer_cache = unflatten_dict({k: v[index] for k, v in flat_cache.items()})
            x, _ = self.block(unflatten_dict(dict(zip(flat, leaves))), x,
                              ctx.layer(index, self.n), cache=layer_cache, **kw)
        return x, cache
