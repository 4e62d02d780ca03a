"""whisper-large-v3 [audio] — enc-dec, conv frontend stubbed
[arXiv:2212.04356; unverified] (a copy of the JAX package's
``configs/whisper_large_v3.py``).

32L encoder + 32L decoder, d_model=1280 20H (MHA kv=20) d_ff=5120
vocab=51866.  The mel->conv1d stem is a STUB: input_specs provides
precomputed frame embeddings (B, 1500, 1280).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-large-v3",
    family="audio",
    n_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv=20,
    d_ff=5120,
    vocab=51866,
    norm="layernorm",
    act="gelu",
    qkv_bias=True,
    encoder_layers=32,
    encoder_seq=1500,
    parallelism="dp_only",
    source="arXiv:2212.04356",
)
