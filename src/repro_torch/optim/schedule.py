"""Step-indexed learning-rate schedules (Python floats of the step)."""
from __future__ import annotations

import math


def constant(value: float):
    return lambda step: float(value)


def cosine_decay(peak: float, total_steps: int, floor: float = 0.0):
    def f(step):
        t = min(max(step / max(total_steps, 1), 0.0), 1.0)
        return floor + 0.5 * (peak - floor) * (1 + math.cos(math.pi * t))
    return f


def linear_warmup_cosine(peak: float, warmup: int, total_steps: int,
                         floor: float = 0.0):
    def f(step):
        if step < warmup:
            return peak * step / max(warmup, 1)
        t = min(max((step - warmup) / max(total_steps - warmup, 1), 0.0), 1.0)
        return floor + 0.5 * (peak - floor) * (1 + math.cos(math.pi * t))
    return f
