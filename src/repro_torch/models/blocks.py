"""The pre-norm transformer block, the Mamba and xLSTM layer adapters, and
the layer period (port of ``models/blocks.py``'s ``TransformerBlock``,
``MambaWrap``, ``XLSTMWrap`` and ``build_period``, without cross-attention).

LayerNorm/GELU blocks for the ViT (bidirectional, no rotary embeddings),
RMSNorm/SwiGLU blocks with rotary embeddings for the decoder LMs, as the
JAX package picks them from the configuration; a block's feed-forward is an
MLP or, with ``use_moe``, routed experts (``nn/moe.py``) plus Arctic's
parallel dense-residual MLP (``moe_dense_ff``).  The decoder LMs train and
serve through it (causal attention through ``flash_attention_train`` in
training, the cache and the attention kernel in serving).  ``MambaWrap`` is
a Jamba layer (a Mamba block, then an MLP or the experts), ``XLSTMWrap`` an
xLSTM block behind the same interface.  A period longer than one block
(an explicit ``block_pattern``, or MoE on every ``moe_every``-th layer) is
a ``SequentialBlocks``; the MoE layers are those with
``i % moe_every == moe_every - 1``, as in the JAX package.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.taps import Ctx
from repro_torch.nn.attention import Attention, make_kv_cache
from repro_torch.nn.mlp import MLP, GatedMLP
from repro_torch.nn.module import LayerNorm, Module, Params, RMSNorm
from repro_torch.nn.mamba import MambaBlock
from repro_torch.nn.moe import MoE
from repro_torch.nn.stack import SequentialBlocks
from repro_torch.nn.xlstm import MLSTMBlock, SLSTMBlock


def _norm(cfg: ArchConfig, name: str, d: int, **common) -> Module:
    cls = RMSNorm if cfg.norm == "rmsnorm" else LayerNorm
    return cls(name, d, **common)


def _ffn(cfg: ArchConfig, name: str, d_ff: int, **common) -> Module:
    cls = GatedMLP if cfg.act == "swiglu" else MLP
    return cls(name, cfg.d_model, d_ff, **common)


class TransformerBlock(Module):
    """x + attn(n1(x)), then x + ffn(n2(x)) with ffn an MLP, or the experts
    plus (Arctic) a parallel dense MLP on the same input."""

    def __init__(self, name: str, cfg: ArchConfig, *, use_moe: bool = False,
                 causal: bool = True, dtype=torch.float32, param_dtype=torch.float32,
                 device: torch.device):
        self.name = name
        self.cfg = cfg
        self.device = device
        self.use_moe = use_moe and cfg.moe_experts > 0
        d = cfg.d_model
        common = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.n1 = _norm(cfg, "n1", d, **common)
        self.attn = Attention(
            "attn", d, cfg.n_heads, cfg.n_kv, head_dim=cfg.head_dim, qkv_bias=cfg.qkv_bias,
            use_rope=cfg.norm == "rmsnorm",  # LayerNorm families use learned positions
            rope_theta=cfg.rope_theta, causal=causal, window=cfg.window,
            block_q=cfg.attn_block_q, block_kv=cfg.attn_block_kv, **common,
        )
        self.n2 = _norm(cfg, "n2", d, **common)
        if self.use_moe:
            self.moe = MoE("moe", d, cfg.d_ff, cfg.moe_experts, cfg.moe_top_k,
                           capacity_factor=cfg.capacity_factor, **common)
            if cfg.moe_dense_ff:
                self.dense_mlp = _ffn(cfg, "dense_mlp", cfg.moe_dense_ff, **common)
        else:
            self.mlp = _ffn(cfg, "mlp", cfg.d_ff, **common)

    def init(self, generator: torch.Generator) -> Params:
        p = {"n1": self.n1.init(generator), "attn": self.attn.init(generator),
             "n2": self.n2.init(generator)}
        if self.use_moe:
            p["moe"] = self.moe.init(generator)
            if self.cfg.moe_dense_ff:
                p["dense_mlp"] = self.dense_mlp.init(generator)
        else:
            p["mlp"] = self.mlp.init(generator)
        return p

    def init_cache(self, batch: int, dtype: torch.dtype, *, max_len: int) -> dict:
        return {"kv": make_kv_cache(batch, max_len, self.attn.n_kv, self.attn.head_dim, dtype,
                                    window=self.cfg.window, device=self.device)}

    def __call__(self, params: Params, x: torch.Tensor, ctx: Ctx, *,
                 cache: Optional[dict] = None, positions: Optional[torch.Tensor] = None,
                 dispatch: str = "per_sample"):
        """Without ``cache`` returns x; with it, (x, cache).  ``dispatch`` is
        the experts' ("per_sample" in training, "global" in serving)."""
        h = self.attn(params["attn"], self.n1(params["n1"], x, ctx.scope("n1")),
                      ctx.scope("attn"), positions=positions,
                      cache=None if cache is None else cache["kv"])
        if cache is not None:
            h, _ = h
        x = x + h
        h_in = self.n2(params["n2"], x, ctx.scope("n2"))
        if self.use_moe:
            h = self.moe(params["moe"], h_in, ctx.scope("moe"), dispatch=dispatch)
            if self.cfg.moe_dense_ff:
                h = h + self.dense_mlp(params["dense_mlp"], h_in, ctx.scope("dense_mlp"))
        else:
            h = self.mlp(params["mlp"], h_in, ctx.scope("mlp"))
        x = x + h
        return x if cache is None else (x, cache)


class MambaWrap(Module):
    """x + mamba(n1(x)), then x + ffn(n2(x)) with ffn an MLP or the experts
    (the Jamba layer layout)."""

    def __init__(self, name: str, cfg: ArchConfig, *, use_moe: bool, dtype=torch.float32,
                 param_dtype=torch.float32, device: torch.device):
        self.name = name
        self.cfg = cfg
        self.use_moe = use_moe and cfg.moe_experts > 0
        d = cfg.d_model
        common = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.n1 = _norm(cfg, "n1", d, **common)
        self.mamba = MambaBlock("mamba", d, head_dim=cfg.ssm_head_dim, d_state=cfg.ssm_d_state,
                                chunk=cfg.ssm_chunk, **common)
        self.n2 = _norm(cfg, "n2", d, **common)
        if self.use_moe:
            self.moe = MoE("moe", d, cfg.d_ff, cfg.moe_experts, cfg.moe_top_k,
                           capacity_factor=cfg.capacity_factor, **common)
        else:
            self.mlp = _ffn(cfg, "mlp", cfg.d_ff, **common)

    def init(self, generator: torch.Generator) -> Params:
        p = {"n1": self.n1.init(generator), "mamba": self.mamba.init(generator),
             "n2": self.n2.init(generator)}
        if self.use_moe:
            p["moe"] = self.moe.init(generator)
        else:
            p["mlp"] = self.mlp.init(generator)
        return p

    def init_cache(self, batch: int, dtype: torch.dtype, **kw) -> dict:
        return {"mamba": self.mamba.init_cache(batch, dtype)}

    def __call__(self, params: Params, x: torch.Tensor, ctx: Ctx, *,
                 cache: Optional[dict] = None, positions: Optional[torch.Tensor] = None,
                 dispatch: str = "per_sample"):
        del positions  # the recurrence carries position
        h = self.mamba(params["mamba"], self.n1(params["n1"], x, ctx.scope("n1")),
                       ctx.scope("mamba"), cache=None if cache is None else cache["mamba"])
        if cache is not None:
            h, _ = h
        x = x + h
        h_in = self.n2(params["n2"], x, ctx.scope("n2"))
        if self.use_moe:
            h = self.moe(params["moe"], h_in, ctx.scope("moe"), dispatch=dispatch)
        else:
            h = self.mlp(params["mlp"], h_in, ctx.scope("mlp"))
        x = x + h
        return x if cache is None else (x, cache)


class XLSTMWrap(Module):
    """An mLSTM or sLSTM block (each with its own residuals) behind the
    uniform block interface; params and cache under ``"b"``."""

    def __init__(self, name: str, cfg: ArchConfig, kind: str, *, dtype=torch.float32,
                 param_dtype=torch.float32, device: torch.device):
        self.name = name
        self.kind = kind
        common = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        if kind == "mlstm":
            self.block = MLSTMBlock("m", cfg.d_model, cfg.n_heads, chunk=cfg.ssm_chunk, **common)
        else:
            self.block = SLSTMBlock("s", cfg.d_model, cfg.n_heads, **common)

    def init(self, generator: torch.Generator) -> Params:
        return {"b": self.block.init(generator)}

    def init_cache(self, batch: int, dtype: torch.dtype, **kw) -> dict:
        return {"b": self.block.init_cache(batch, dtype)}

    def __call__(self, params: Params, x: torch.Tensor, ctx: Ctx, *,
                 cache: Optional[dict] = None, positions: Optional[torch.Tensor] = None,
                 dispatch: str = "per_sample"):
        del positions, dispatch
        out = self.block(params["b"], x, ctx.scope("b"),
                         cache=None if cache is None else cache["b"])
        return out if cache is None else (out[0], cache)


def build_period(cfg: ArchConfig, *, causal: bool = True, dtype=torch.float32,
                 param_dtype=torch.float32, device: torch.device) -> tuple[Module, int]:
    """The repeating period and its count: one block for the dense LMs and
    MoE on every layer, else a ``SequentialBlocks`` of ``moe_every``
    transformer blocks or of the explicit pattern's blocks."""
    common = dict(dtype=dtype, param_dtype=param_dtype, device=device)

    def use_moe(i: int) -> bool:
        return cfg.moe_experts > 0 and i % cfg.moe_every == cfg.moe_every - 1

    pattern = cfg.block_pattern
    if not pattern:
        period = cfg.moe_every if cfg.moe_experts else 1
        blocks = [TransformerBlock(f"b{i}", cfg, use_moe=use_moe(i), causal=causal, **common)
                  for i in range(period)]
    else:
        period = len(pattern)
        blocks = []
        for i, kind in enumerate(pattern):
            if kind == "attn":
                blocks.append(TransformerBlock(f"b{i}", cfg, use_moe=use_moe(i), **common))
            elif kind == "mamba":
                blocks.append(MambaWrap(f"b{i}", cfg, use_moe=use_moe(i), **common))
            elif kind in ("mlstm", "slstm"):
                blocks.append(XLSTMWrap(f"b{i}", cfg, kind, **common))
            else:
                raise ValueError(f"{cfg.name}: unknown block kind {kind!r}")
    if cfg.n_layers % period:
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers not a multiple of the period "
                         f"{period}")
    if not pattern and period == 1:  # an explicit pattern stays a period, as in JAX
        return blocks[0], cfg.n_layers
    return SequentialBlocks("period", blocks), cfg.n_layers // period
