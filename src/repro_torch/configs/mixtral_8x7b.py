"""mixtral-8x7b [moe] — 8 experts top-2, SWA [arXiv:2401.04088; hf] (a copy of
the JAX package's ``configs/mixtral_8x7b.py``).

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000, MoE 8e top-2,
sliding-window 4096.  SWA bounds the reachable context, so long_500k decode
runs on a 4096-slot ring KV cache.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv=8,
    d_ff=14336,
    vocab=32000,
    moe_experts=8,
    moe_top_k=2,
    window=4096,
    rope_theta=1e6,
    sub_quadratic=True,  # via SWA ring cache
    source="arXiv:2401.04088",
)
