"""The pre-norm transformer block (port of ``models/blocks.py``'s
``TransformerBlock``, without MoE or cross-attention).

LayerNorm/GELU blocks for the ViT (bidirectional, no rotary embeddings),
RMSNorm/SwiGLU blocks with rotary embeddings for the decoder LMs, as the
JAX package picks them from the configuration.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.taps import Ctx
from repro_torch.nn.attention import Attention, make_kv_cache
from repro_torch.nn.mlp import MLP, GatedMLP
from repro_torch.nn.module import LayerNorm, Module, Params, RMSNorm


def _norm(cfg: ArchConfig, name: str, d: int, **common) -> Module:
    cls = RMSNorm if cfg.norm == "rmsnorm" else LayerNorm
    return cls(name, d, **common)


def _ffn(cfg: ArchConfig, name: str, d_ff: int, **common) -> Module:
    cls = GatedMLP if cfg.act == "swiglu" else MLP
    return cls(name, cfg.d_model, d_ff, **common)


class TransformerBlock(Module):
    """x + attn(n1(x)), then x + mlp(n2(x))."""

    def __init__(self, name: str, cfg: ArchConfig, *, causal: bool = True,
                 dtype=torch.float32, param_dtype=torch.float32, device: torch.device):
        if cfg.moe_experts:
            raise NotImplementedError(f"{cfg.name}: MoE blocks come with the MoE slice")
        self.name = name
        self.cfg = cfg
        self.device = device
        d = cfg.d_model
        common = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.n1 = _norm(cfg, "n1", d, **common)
        self.attn = Attention(
            "attn", d, cfg.n_heads, cfg.n_kv, head_dim=cfg.head_dim, qkv_bias=cfg.qkv_bias,
            use_rope=cfg.norm == "rmsnorm",  # LayerNorm families use learned positions
            rope_theta=cfg.rope_theta, causal=causal, window=cfg.window, **common,
        )
        self.n2 = _norm(cfg, "n2", d, **common)
        self.mlp = _ffn(cfg, "mlp", cfg.d_ff, **common)

    def init(self, generator: torch.Generator) -> Params:
        return {"n1": self.n1.init(generator), "attn": self.attn.init(generator),
                "n2": self.n2.init(generator), "mlp": self.mlp.init(generator)}

    def init_cache(self, batch: int, dtype: torch.dtype, *, max_len: int) -> dict:
        return {"kv": make_kv_cache(batch, max_len, self.attn.n_kv, self.attn.head_dim, dtype,
                                    window=self.cfg.window, device=self.device)}

    def __call__(self, params: Params, x: torch.Tensor, ctx: Ctx, *,
                 cache: Optional[dict] = None, positions: Optional[torch.Tensor] = None):
        """Without ``cache`` returns x; with it, (x, cache)."""
        h = self.attn(params["attn"], self.n1(params["n1"], x, ctx.scope("n1")),
                      ctx.scope("attn"), positions=positions,
                      cache=None if cache is None else cache["kv"])
        if cache is not None:
            h, _ = h
        x = x + h
        x = x + self.mlp(params["mlp"], self.n2(params["n2"], x, ctx.scope("n2")),
                         ctx.scope("mlp"))
        return x if cache is None else (x, cache)
