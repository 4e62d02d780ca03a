"""The pre-norm transformer block (port of ``models/blocks.py``'s
``TransformerBlock``, without MoE, cross-attention or a KV cache)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.taps import Ctx
from repro_torch.nn.attention import Attention
from repro_torch.nn.mlp import MLP
from repro_torch.nn.module import LayerNorm, Module, Params


class TransformerBlock(Module):
    """x + attn(n1(x)), then x + mlp(n2(x)): LayerNorm and GELU, as ViT/BEiT.

    RMSNorm, SwiGLU, rotary embeddings and MoE come with the LM slice.
    """

    def __init__(self, name: str, cfg: ArchConfig, *, dtype=torch.float32,
                 param_dtype=torch.float32, device: torch.device):
        if cfg.norm != "layernorm" or cfg.act != "gelu" or cfg.moe_experts:
            raise NotImplementedError(
                f"{cfg.name}: only LayerNorm/GELU blocks without MoE are ported (ViT); "
                "the rest comes with the LM slice"
            )
        self.name = name
        d = cfg.d_model
        common = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.n1 = LayerNorm("n1", d, **common)
        self.attn = Attention("attn", d, cfg.n_heads, cfg.n_kv, head_dim=cfg.head_dim,
                              qkv_bias=cfg.qkv_bias, **common)
        self.n2 = LayerNorm("n2", d, **common)
        self.mlp = MLP("mlp", d, cfg.d_ff, **common)

    def init(self, generator: torch.Generator) -> Params:
        return {"n1": self.n1.init(generator), "attn": self.attn.init(generator),
                "n2": self.n2.init(generator), "mlp": self.mlp.init(generator)}

    def __call__(self, params: Params, x: torch.Tensor, ctx: Ctx) -> torch.Tensor:
        x = x + self.attn(params["attn"], self.n1(params["n1"], x, ctx.scope("n1")),
                          ctx.scope("attn"))
        h = self.mlp(params["mlp"], self.n2(params["n2"], x, ctx.scope("n2")), ctx.scope("mlp"))
        return x + h
