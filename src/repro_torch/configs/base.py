"""Architecture and shape configuration (a copy of ``configs/base.py``'s
``ArchConfig`` and ``ShapeConfig``).

Pure Python, kept here so the port never imports the JAX package.  The
fields, their defaults and ``reduced()`` are the JAX package's, so a test
can build the same model in both packages from one configuration.  The
port reads ``dtype``/``param_dtype`` through ``torch_dtype``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

# float64: compute for gates that an fp32 reduction's rounding would blur
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float64": torch.float64}


def torch_dtype(name: str) -> torch.dtype:
    """A configuration's dtype name ("float32", "bfloat16", "float64") as a
    torch dtype."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}; have {sorted(_DTYPES)}") from None


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | audio | vlm | cnn | vit
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    rope_theta: float = 1e6
    window: Optional[int] = None  # sliding-window attention (Mixtral)
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    act: str = "swiglu"  # swiglu | gelu
    # MoE
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_every: int = 1  # MoE on layer i iff i % moe_every == moe_every - 1
    moe_dense_ff: int = 0  # Arctic: parallel dense-residual MLP width
    capacity_factor: float = 1.25
    # hybrid (Jamba): per-period block pattern; empty = all-attention
    block_pattern: tuple[str, ...] = ()  # entries: "attn" | "mamba" | "slstm" | "mlstm"
    # SSM dims
    ssm_d_state: int = 64
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    # encoder-decoder (Whisper)
    encoder_layers: int = 0
    encoder_seq: int = 0  # stub frontend: precomputed frame embeddings
    # VLM (phi-3-vision): stub frontend provides patch embeddings
    prefix_tokens: int = 0
    prefix_dim: int = 0
    # precision
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    opt_state_dtype: str = "float32"
    # runtime
    parallelism: str = "tp"
    scan_layers: bool = True
    remat: bool = True
    attn_block_q: int = 512
    attn_block_kv: int = 512
    # whether long_500k is runnable (sub-quadratic / bounded-context)
    sub_quadratic: bool = False
    # DP defaults
    clipping_mode: str = "mixed_ghost"
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def supports(self, shape: ShapeConfig) -> bool:
        if shape.name == "long_500k":
            return self.sub_quadratic
        return True

    def reduced(self) -> "ArchConfig":
        """CPU-smoke variant: same topology, tiny dims."""
        pattern = self.block_pattern
        n_layers = max(2, min(4, self.n_layers)) if not pattern else len(pattern)
        heads = max(2, min(4, self.n_heads))
        kv = max(1, min(self.n_kv, heads))
        # keep the GQA grouping style (kv<heads vs kv==heads)
        if self.n_kv == self.n_heads:
            kv = heads
        return dataclasses.replace(
            self,
            n_layers=n_layers,
            d_model=64,
            n_heads=heads,
            n_kv=kv,
            head_dim=None,
            d_ff=96 if self.d_ff else 0,
            vocab=128,
            moe_experts=min(self.moe_experts, 4),
            moe_dense_ff=48 if self.moe_dense_ff else 0,
            encoder_layers=2 if self.encoder_layers else 0,
            encoder_seq=12 if self.encoder_seq else 0,
            prefix_tokens=4 if self.prefix_tokens else 0,
            prefix_dim=16 if self.prefix_dim else 0,
            ssm_d_state=8,
            ssm_head_dim=8,
            ssm_chunk=8,
            attn_block_q=16,
            attn_block_kv=16,
            dtype="float32",
            param_dtype="float32",
        )
