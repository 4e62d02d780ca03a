"""Mixture-of-Experts with per-sample capacity dispatch (port of ``nn/moe.py``).

Two dispatch modes, as in the JAX package:

- ``per_sample`` (DP training): capacity is allocated per (sample, expert),
  so every expert product keeps the batch dimension and each sample's
  contribution stays its own: the expert taps record a (B, E, C, d) with
  ``n_groups = E`` and the ghost norm sums over the experts.
- ``global`` (serving): the tokens of the whole batch share the experts'
  capacity (no DP).

Dispatch is gather-based: a (token, choice) entry's slot is the number of
earlier entries, in token-major, choice-minor order, routed to the same
expert; entries at or over capacity are dropped and their combine weight
is zero.  The JAX package writes the slot table with a scatter in
``mode="drop"``; PyTorch has no such mode, so a dropped entry writes into a
sentinel slot ``C`` of its expert, which is sliced off.  The tables are
built batched over samples with functional scatters and gathers, so the
``vmap`` oracle (``torch.func``) runs the same code.  An empty slot holds
the sentinel token ``T`` and gathers a zero row.  Expert weights are
(E, d, f) and (E, f, d), the JAX layout; the router is an fp32 ``Dense``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core.taps import Ctx
from repro_torch.nn.module import AxesTree, Dense, Module, Params, normal_init
from repro_torch.parallel.reshard import reshard_param


def dispatch_tables(logits: torch.Tensor, top_k: int, capacity: int):
    """Routing of each sample's tokens: logits (B, T, E) ->
    (table (B, E, C) token per slot, T = empty; idx, slot (B, T, k) int64;
    gates (B, T, k) fp32; keep (B, T, k) bool), the batched
    ``_dispatch_one``."""
    b, t, e = logits.shape
    gate_logits, idx = torch.topk(logits, top_k, dim=-1)  # (B, T, k)
    gates = torch.softmax(gate_logits.float(), dim=-1)
    flat_e = idx.reshape(b, t * top_k)  # token-major, choice-minor
    # (B, T*k, E); F.one_hot reads the ids' range, which vmap refuses
    onehot = (flat_e[..., None] == torch.arange(e, device=logits.device)).long()
    slot = ((torch.cumsum(onehot, dim=1) - onehot) * onehot).sum(dim=-1)  # (B, T*k)
    keep = slot < capacity
    token = torch.arange(t, device=logits.device).repeat_interleave(top_k)
    # kept entries fill distinct (expert, slot) cells; dropped ones share
    # each expert's sentinel cell C, sliced off below
    cell = flat_e * (capacity + 1) + torch.where(keep, slot, torch.full_like(slot, capacity))
    table = torch.full((b, e * (capacity + 1)), t, dtype=torch.long, device=logits.device)
    table = table.scatter(1, cell, token.expand(b, -1))
    table = table.reshape(b, e, capacity + 1)[:, :, :capacity]
    shape = (b, t, top_k)
    return table, idx, slot.reshape(shape), gates, keep.reshape(shape)


def dispatch_tokens(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """x (B, T, d), table (B, E, C) -> xe (B, E, C, d); empty slots zero."""
    b, t, d = x.shape
    xp = torch.cat([x, x.new_zeros((b, 1, d))], dim=1)  # row T: the empty slot
    e, c = table.shape[1:]
    rows = table.reshape(b, e * c, 1).expand(b, e * c, d)
    return torch.gather(xp, 1, rows).reshape(b, e, c, d)


def combine(ye: torch.Tensor, idx, slot, gates, keep) -> torch.Tensor:
    """ye (B, E, C, p) -> (B, T, p): each token's kept choices weighted by
    their gates (fp32 where ye is narrower), the batched ``_combine_one``."""
    b, e, c, p = ye.shape
    t, k = idx.shape[1:]
    flat = (idx * c + slot.clamp(0, c - 1)).reshape(b, t * k, 1).expand(b, t * k, p)
    picked = torch.gather(ye.reshape(b, e * c, p), 1, flat)  # (B, T*k, p)
    w = (gates * keep.to(gates.dtype)).reshape(b, t * k, 1)
    return (picked * w).reshape(b, t, k, p).sum(dim=2)


class MoE(Module):
    """Top-k routed SwiGLU experts."""

    def __init__(
        self, name: str, d_model: int, d_ff: int, n_experts: int, top_k: int = 2, *,
        capacity_factor: float = 1.25, dtype=torch.float32, param_dtype=torch.float32,
        device: torch.device,
    ):
        self.name = name
        self.d_model = d_model
        self.d_ff = d_ff
        self.n_experts = n_experts
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.dtype = dtype
        self.param_dtype = param_dtype
        self.device = device
        self.router = Dense(f"{name}.router", d_model, n_experts, use_bias=False,
                            w_axes=("embed", None), dtype=torch.float32,
                            param_dtype=torch.float32, device=device)

    def init(self, generator: torch.Generator) -> Params:
        e, d, f = self.n_experts, self.d_model, self.d_ff
        common = dict(dtype=self.param_dtype, device=self.device)
        return {
            "router": self.router.init(generator),
            "wg": normal_init(generator, (e, d, f), 1.0 / math.sqrt(d), **common),
            "wu": normal_init(generator, (e, d, f), 1.0 / math.sqrt(d), **common),
            "wo": normal_init(generator, (e, f, d), 1.0 / math.sqrt(f), **common),
        }

    def axes(self) -> AxesTree:
        return {
            "router": self.router.axes(),
            "wg": ("expert", "embed", "moe_mlp"),
            "wu": ("expert", "embed", "moe_mlp"),
            "wo": ("expert", "moe_mlp", "embed"),
        }

    def capacity(self, tokens_per_dispatch: int) -> int:
        cap = int(math.ceil(tokens_per_dispatch * self.top_k / self.n_experts
                            * self.capacity_factor))
        return max(cap, self.top_k)

    def __call__(self, params: Params, x: torch.Tensor, ctx: Ctx, *,
                 dispatch: str = "per_sample") -> torch.Tensor:
        """x (B, T, d) -> (B, T, d); ``dispatch`` "per_sample" (DP training)
        or "global" (serving)."""
        b, t, d = x.shape
        if dispatch == "global":
            x = x.reshape(1, b * t, d)
        elif dispatch != "per_sample":
            raise ValueError(f"dispatch {dispatch!r}: 'per_sample' or 'global'")
        logits = self.router(params["router"], x, ctx.scope("router"))  # fp32
        cap = self.capacity(x.shape[1])
        table, idx, slot, gates, keep = dispatch_tables(logits, self.top_k, cap)
        xe = dispatch_tokens(x, table).to(self.dtype)  # (B, E, C, d)
        f, e = self.d_ff, self.n_experts
        up_axes, down_axes = ("expert", "embed", "moe_mlp"), ("expert", "moe_mlp", "embed")
        wg = reshard_param(params["wg"].to(self.dtype), up_axes, (e, d, f))
        wu = reshard_param(params["wu"].to(self.dtype), up_axes, (e, d, f))
        wo = reshard_param(params["wo"].to(self.dtype), down_axes, (e, f, d))
        gate = torch.matmul(xe, wg)
        up = torch.matmul(xe, wu)
        if ctx.collect:
            tap = dict(kind="matmul", a=xe, T=cap, D=d, p=f, n_groups=e)
            gate = ctx.tap("wg@out", gate, param_path="wg", **tap)
            up = ctx.tap("wu@out", up, param_path="wu", **tap)
        act = F.silu(gate) * up
        ye = torch.matmul(act, wo)
        if ctx.collect:
            ye = ctx.tap("wo@out", ye, kind="matmul", a=act, T=cap, D=f, p=d, n_groups=e,
                         param_path="wo")
        y = combine(ye, idx, slot, gates, keep).to(self.dtype)
        return y.reshape(b, t, d)
