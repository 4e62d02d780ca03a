"""arctic-480b [moe] — 128 experts top-2 + dense residual
[hf:Snowflake/snowflake-arctic-base; hf] (a copy of
the JAX package's ``configs/arctic_480b.py``).

35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000, MoE 128e top-2 with a
parallel dense-residual MLP (width d_model, matching Arctic's ~10B dense
trunk / 35 layers).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv=8,
    d_ff=4864,
    vocab=32000,
    moe_experts=128,
    moe_top_k=2,
    moe_dense_ff=7168,
    rope_theta=1e6,
    param_dtype="bfloat16",
    opt_state_dtype="bfloat16",
    source="hf:Snowflake/snowflake-arctic-base",
)
