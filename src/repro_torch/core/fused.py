"""Fused probes: per-sample norms (and book-keeping banks) computed inside
the backward pass (port of ``core/fused.py``).

Each parameterized op routes its pre-activation through ``Probe``, an
identity ``torch.autograd.Function`` that keeps the op's input ``a`` and a
0-dim dummy leaf ``z``::

    forward:   s -> s                       (identity; saves a)
    backward:  ds = g                       (the cotangent flows on)
               bank = ghost.tap_bank(a, g)  -> runtime.banks[key]
                                            (the runtime's knobs, plan)
               dz = 0                       (z only marks the probe)

``key`` is ``(tap name, layer)``: each layer of a stack banks under its own
key with the per-layer meta, where the JAX package's scan stacks the banks.

The JAX version returns the bank as ``z``'s cotangent.  Here the bank is
written to the step's ``ClipRuntime`` instead, and ``z`` only gives the
first backward something to ask for: ``torch.autograd.grad(losses,
inputs=zs)`` runs every probe while autograd prunes every parameter-
gradient kernel (the counterpart of XLA's dead-code elimination of the
parameter grads, ``clipping.py:492`` in the JAX package).

A second backward over the same graph (``mixed_ghost``'s clipped-gradient
pass) runs ``Probe.backward`` again; with ``runtime.phase == "grad"`` it
only passes the cotangent through, so the banks are computed once per step
(in JAX the second pullback's bank computation is dead code).

Under a rematerialised stack (``nn/stack.py``) a layer's probes run their
forward again in each backward, which restores the saved ``a``; their
backward runs on the original graph only, so each (tap, layer) banks once
a step, in the ``"bank"`` phase, and the banks stay outside the recomputed
region.
"""
from __future__ import annotations

import torch

from repro_torch.core import ghost
from repro_torch.core.taps import BankKey, ClipRuntime, TapMeta


class Probe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, s, a, z, key, meta, runtime):  # noqa: ARG004 - z marks the probe
        ctx.save_for_backward(a)
        ctx.key = key
        ctx.meta = meta
        ctx.runtime = runtime
        return s.view_as(s)

    @staticmethod
    def backward(ctx, g):
        runtime: ClipRuntime = ctx.runtime
        if runtime.phase != "bank":
            return g, None, None, None, None, None
        (a,) = ctx.saved_tensors
        runtime.banks[ctx.key] = ghost.tap_bank(ctx.meta, a, g, **runtime.tap_args(ctx.key[0]))
        return g, None, g.new_zeros(()), None, None, None


def probe(
    s: torch.Tensor, a: torch.Tensor, z: torch.Tensor, key: BankKey, meta: TapMeta,
    runtime: ClipRuntime,
) -> torch.Tensor:
    """Identity on ``s`` whose backward banks ``key`` into ``runtime``
    (``a`` None: a bias tap, banked from its cotangent alone)."""
    return Probe.apply(s, None if a is None else a.detach(), z, key, meta, runtime)
