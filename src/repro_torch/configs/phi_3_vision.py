"""phi-3-vision-4.2b [vlm] — phi3-mini backbone + CLIP stub
[hf:microsoft/Phi-3-vision-128k-instruct; hf] (a copy of the JAX package's
``configs/phi_3_vision.py``).

32L d_model=3072 32H (MHA kv=32) d_ff=8192 vocab=32064.  The CLIP ViT-L/14
image tower is a STUB: input_specs provides precomputed patch embeddings
(B, 576, 1024) which a trainable projector maps into the LM.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv=32,
    d_ff=8192,
    vocab=32064,
    rope_theta=1e4,
    prefix_tokens=576,
    prefix_dim=1024,
    parallelism="dp_only",
    source="hf:microsoft/Phi-3-vision-128k-instruct",
)
