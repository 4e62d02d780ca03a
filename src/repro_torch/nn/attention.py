"""Multi-head self-attention, the training path (port of ``nn/attention.py``).

The projections are ``Dense`` modules, so each gets a DP tap; the
attention itself has no parameters and the clipping engine never sees it.
The JAX package computes training attention in fp32 outside any Pallas
kernel (``kernels/flash_attention/ops.py``'s custom VJP), so here it is
plain PyTorch softmax attention on fp32 copies of q, k and v, returned in
the model dtype.  It runs the same ops in every backward, so
``mixed_ghost``'s second backward over the retained graph repeats the
first's arithmetic.  The KV cache, rotary embeddings, causal and
sliding-window masks, grouped KV heads and cross-attention come with the
LM and serving slices.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.taps import Ctx
from repro_torch.nn.module import Dense, Module, Params


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Bidirectional softmax attention in fp32: q, k, v (B, S, H, hd) ->
    (B, S, H, hd) in q's dtype."""
    hd = q.shape[-1]
    qf, kf, vf = (x.float().transpose(1, 2) for x in (q, k, v))  # (B, H, S, hd)
    probs = torch.softmax(qf @ kf.transpose(-1, -2) * hd**-0.5, dim=-1)
    return (probs @ vf).transpose(1, 2).to(q.dtype)


class Attention(Module):
    def __init__(
        self, name: str, d_model: int, n_heads: int, n_kv: int, *,
        head_dim: Optional[int] = None, qkv_bias: bool = False,
        dtype=torch.float32, param_dtype=torch.float32, device: torch.device,
    ):
        if n_kv != n_heads:
            raise NotImplementedError("grouped KV heads come with the LM slice")
        self.name = name
        self.n_heads = n_heads
        self.head_dim = head_dim or d_model // n_heads
        width = n_heads * self.head_dim
        common = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.wq = Dense(f"{name}.q", d_model, width, use_bias=qkv_bias, **common)
        self.wk = Dense(f"{name}.k", d_model, width, use_bias=qkv_bias, **common)
        self.wv = Dense(f"{name}.v", d_model, width, use_bias=qkv_bias, **common)
        self.wo = Dense(f"{name}.o", width, d_model, use_bias=False, **common)

    def init(self, generator: torch.Generator) -> Params:
        return {
            "q": self.wq.init(generator),
            "k": self.wk.init(generator),
            "v": self.wv.init(generator),
            "o": self.wo.init(generator),
        }

    def __call__(self, params: Params, x: torch.Tensor, ctx: Ctx) -> torch.Tensor:
        b, s, _ = x.shape
        heads = (b, s, self.n_heads, self.head_dim)
        q = self.wq(params["q"], x, ctx.scope("q")).reshape(heads)
        k = self.wk(params["k"], x, ctx.scope("k")).reshape(heads)
        v = self.wv(params["v"], x, ctx.scope("v")).reshape(heads)
        out = attention(q, k, v)
        return self.wo(params["o"], out.reshape(b, s, -1), ctx.scope("o"))
