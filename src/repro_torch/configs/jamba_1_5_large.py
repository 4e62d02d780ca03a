"""jamba-1.5-large-398b [hybrid] — Mamba+attn 1:7, MoE 16e top-2
[arXiv:2403.19887; hf] (a copy of
the JAX package's ``configs/jamba_1_5_large.py``).

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536.  Period of 8 layers:
attention at index 3, Mamba elsewhere (1:7), MoE on every other layer.
Hardware adaptation: Mamba layers use the SSD scalar-decay form (Mamba-2)
whose chunked scan is matrix products (``nn/mamba.py``).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv=8,
    d_ff=24576,
    vocab=65536,
    moe_experts=16,
    moe_top_k=2,
    moe_every=2,
    block_pattern=("mamba", "mamba", "mamba", "attn", "mamba", "mamba", "mamba", "mamba"),
    ssm_d_state=64,
    ssm_head_dim=64,
    sub_quadratic=True,
    param_dtype="bfloat16",
    opt_state_dtype="bfloat16",
    source="arXiv:2403.19887",
)
