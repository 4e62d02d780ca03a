"""Paper-native transformer configs (a copy of ``configs/paper_native.py``):
ViT-Base/16 and BEiT-Large/16, the convolutional-ViT DP models of the
paper's Table 5."""
from repro_torch.configs.base import ArchConfig

VIT_BASE = ArchConfig(
    name="vit-base-patch16",
    family="vit",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv=12,
    d_ff=3072,
    vocab=0,
    norm="layernorm",
    act="gelu",
    qkv_bias=True,
    source="arXiv:2010.11929",
)

BEIT_LARGE = ArchConfig(
    name="beit-large-patch16",
    family="vit",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv=16,
    d_ff=4096,
    vocab=0,
    norm="layernorm",
    act="gelu",
    qkv_bias=True,
    source="arXiv:2106.08254 (BEiT); paper Table 5",
)
