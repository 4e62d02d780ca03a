"""codeqwen1.5-7b [dense] — qwen1.5 arch [hf:Qwen/CodeQwen1.5-7B; hf] (a copy
of the JAX package's ``configs/codeqwen1_5_7b.py``).

32L d_model=4096 32H (MHA kv=32) d_ff=13440 vocab=92416, QKV bias.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="codeqwen1.5-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv=32,
    d_ff=13440,
    vocab=92416,
    qkv_bias=True,
    rope_theta=1e6,
    parallelism="dp_only",
    source="hf:Qwen/CodeQwen1.5-7B",
)
