"""qwen2-72b [dense] — GQA, QKV bias [arXiv:2407.10671; hf] (a copy of
the JAX package's ``configs/qwen2_72b.py``).

80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-72b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv=8,
    d_ff=29568,
    vocab=152064,
    qkv_bias=True,
    rope_theta=1e6,
    source="arXiv:2407.10671",
)
