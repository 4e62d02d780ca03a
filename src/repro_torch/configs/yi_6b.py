"""yi-6b [dense] — llama-arch GQA [arXiv:2403.04652; hf] (a copy of the JAX
package's ``configs/yi_6b.py``).

32L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000, no QKV bias.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="yi-6b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv=4,
    d_ff=11008,
    vocab=64000,
    rope_theta=5e6,
    parallelism="dp_only",
    source="arXiv:2403.04652",
)
