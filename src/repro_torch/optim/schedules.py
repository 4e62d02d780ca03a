"""Learning-rate schedules: plain functions of the integer step counter."""
from __future__ import annotations

import math


def constant(lr: float):
    return lambda step: float(lr)


def warmup_linear(lr: float, warmup: int, total: int):
    def fn(step: int) -> float:
        if step < warmup:
            return lr * step / max(warmup, 1)
        return lr * max(0.0, (total - step) / max(total - warmup, 1))

    return fn


def warmup_cosine(lr: float, warmup: int, total: int, min_ratio: float = 0.1):
    def fn(step: int) -> float:
        if step < warmup:
            return lr * step / max(warmup, 1)
        prog = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
        return lr * (min_ratio + (1 - min_ratio) * 0.5 * (1 + math.cos(math.pi * prog)))

    return fn
