"""qwen1.5-32b [dense] — QKV bias [hf:Qwen/Qwen1.5-32B; hf] (a copy of
the JAX package's ``configs/qwen1_5_32b.py``).

64L d_model=5120 40H (MHA kv=40) d_ff=27392 vocab=152064.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv=40,
    d_ff=27392,
    vocab=152064,
    qkv_bias=True,
    rope_theta=1e6,
    source="hf:Qwen/Qwen1.5-32B",
)
