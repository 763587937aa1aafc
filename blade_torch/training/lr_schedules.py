"""Learning-rate schedules with HuggingFace ``get_scheduler`` semantics.

Counterpart of ``blade/training/lr_schedules.py``: the same six lambda
formulas (linear warmup from 0 in every warmup-capable variant; the
multiplier scales the base LR), as plain ``step -> lr`` functions of a
host integer.  Only the generator optimizer is scheduled; the fake-score
optimizer runs at a constant LR.
"""

from __future__ import annotations

import math
from typing import Callable

__all__ = ["make_lr_schedule", "SCHEDULE_NAMES"]

SCHEDULE_NAMES = (
    "constant",
    "constant_with_warmup",
    "linear",
    "cosine",
    "cosine_with_restarts",
    "polynomial",
)


def make_lr_schedule(name: str, base_lr: float, *, warmup_steps: int = 0,
                     total_steps: int = 1, num_cycles: int = 1,
                     power: float = 1.0) -> Callable[[int], float]:
    """``schedule(step) -> lr``; ``total_steps`` counts optimizer steps."""
    if name not in SCHEDULE_NAMES:
        raise ValueError(f"unknown lr_scheduler {name!r}; one of {SCHEDULE_NAMES}")
    w = max(int(warmup_steps), 0)
    total = max(int(total_steps), 1)
    decay_span = max(total - w, 1)

    def multiplier(s: float) -> float:
        if name == "constant":
            return 1.0
        if s < w:
            return s / max(w, 1)
        progress = (s - w) / decay_span
        if name == "constant_with_warmup":
            return 1.0
        if name == "linear":
            return max(0.0, (total - s) / decay_span)
        if name == "cosine":
            return max(0.0, 0.5 * (1.0 + math.cos(math.pi * num_cycles * 2.0 * progress)))
        if name == "cosine_with_restarts":
            if progress >= 1.0:
                return 0.0
            frac = math.fmod(num_cycles * progress, 1.0)
            return max(0.0, 0.5 * (1.0 + math.cos(math.pi * frac)))
        # polynomial: decays base_lr -> lr_end = 1e-7, then holds lr_end
        lr_end = 1e-7
        if not base_lr:
            return 0.0
        if s > total:
            return lr_end / base_lr
        pct = 1.0 - min(max(progress, 0.0), 1.0)
        return ((base_lr - lr_end) * pct ** power + lr_end) / base_lr

    def schedule(step: int) -> float:
        return base_lr * multiplier(float(step))

    return schedule
