"""LR schedules as plain callables step -> lr."""
from __future__ import annotations

import math


def constant(lr: float):
    return lambda step: lr


def linear_warmup_cosine(lr: float, warmup: int, total: int, min_ratio: float = 0.1):
    def f(step):
        if step < warmup:
            return lr * (step + 1) / max(1, warmup)
        t = (step - warmup) / max(1, total - warmup)
        t = min(1.0, t)
        return lr * (min_ratio + (1 - min_ratio) * 0.5 * (1 + math.cos(math.pi * t)))

    return f
