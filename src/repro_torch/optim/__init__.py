from repro_torch.optim.optimizers import Optimizer, adam, adamw, apply_updates, sgd
from repro_torch.optim.schedules import constant, warmup_cosine, warmup_linear

__all__ = [
    "Optimizer", "adam", "adamw", "apply_updates", "sgd",
    "constant", "warmup_cosine", "warmup_linear",
]
