"""Functional optimizers (port of ``optim/optimizers.py``).

An Optimizer is a pair of functions over nested dicts of tensors:
    init(params) -> state
    update(grads, state, params, step, lr) -> (updates, state)
Updates are ADDED to params via ``apply_updates`` (they carry the -lr sign).
DP-SGD / DP-Adam are these optimizers fed the privatized gradient
(Eq. 2.1): the mechanism lives entirely in the gradient, as in the paper.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.utils.tree import tree_map

Params = Any
State = Any


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Params], State]
    update: Callable[..., tuple[Params, State]]


def apply_updates(params: Params, updates: Params) -> Params:
    return tree_map(lambda p, u: (p.float() + u.float()).to(p.dtype), params, updates)


def sgd(momentum: float = 0.0, nesterov: bool = False) -> Optimizer:
    def init(params):
        if momentum == 0.0:
            return {}
        return {"m": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)}

    def update(grads, state, params, step, lr):
        del params, step
        if momentum == 0.0:
            return tree_map(lambda g: -lr * g.float(), grads), state
        m = tree_map(lambda mm, g: momentum * mm + g.float(), state["m"], grads)
        if nesterov:
            upd = tree_map(lambda mm, g: -lr * (momentum * mm + g.float()), m, grads)
        else:
            upd = tree_map(lambda mm: -lr * mm, m)
        return upd, {"m": m}

    return Optimizer(init, update)


def adam(
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    *,
    weight_decay: float = 0.0,
    state_dtype=torch.float32,
) -> Optimizer:
    """Adam / AdamW (decoupled weight decay when weight_decay > 0)."""

    def init(params):
        z = lambda p: torch.zeros(p.shape, dtype=state_dtype, device=p.device)  # noqa: E731
        return {"m": tree_map(z, params), "v": tree_map(z, params)}

    def update(grads, state, params, step, lr):
        t = float(step) + 1.0
        c1 = 1.0 - b1**t
        c2 = 1.0 - b2**t
        m = tree_map(lambda mm, g: (b1 * mm.float() + (1 - b1) * g.float()).to(state_dtype),
                     state["m"], grads)
        v = tree_map(lambda vv, g: (b2 * vv.float() + (1 - b2) * g.float() * g.float())
                     .to(state_dtype), state["v"], grads)

        def upd(mm, vv, p):
            u = -lr * (mm.float() / c1) / (torch.sqrt(vv.float() / c2) + eps)
            if weight_decay:
                u = u - lr * weight_decay * p.float()
            return u

        return tree_map(upd, m, v, params), {"m": m, "v": v}

    return Optimizer(init, update)


def adamw(
    b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 0.01,
    state_dtype=torch.float32,
) -> Optimizer:
    """AdamW: ``adam`` with decoupled weight decay (the JAX package's defaults)."""
    return adam(b1, b2, eps, weight_decay=weight_decay, state_dtype=state_dtype)
