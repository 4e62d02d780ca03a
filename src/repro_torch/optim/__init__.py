from repro_torch.optim.compression import bf16_compress_with_error_feedback, init_error_feedback
from repro_torch.optim.optimizers import Optimizer, adam, adamw, apply_updates, sgd
from repro_torch.optim.schedules import constant, warmup_cosine, warmup_linear

__all__ = [
    "Optimizer", "adam", "adamw", "apply_updates", "sgd",
    "constant", "warmup_cosine", "warmup_linear",
    "bf16_compress_with_error_feedback", "init_error_feedback",
]
