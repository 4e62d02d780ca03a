"""xlstm-350m [ssm] — sLSTM + mLSTM blocks [arXiv:2405.04517; unverified] (a copy of
the JAX package's ``configs/xlstm_350m.py``).

24L d_model=1024 4H d_ff=0 (xLSTM blocks carry their own projections)
vocab=50304.  Period of 8 = 1 sLSTM + 7 mLSTM (the paper's [7:1] ratio).
Recurrent-state decode => long_500k runs.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv=4,
    d_ff=0,
    vocab=50304,
    block_pattern=("slstm",) + ("mlstm",) * 7,
    sub_quadratic=True,
    ssm_chunk=256,
    parallelism="dp_only",
    source="arXiv:2405.04517 (xLSTM); pool tier: unverified",
)
