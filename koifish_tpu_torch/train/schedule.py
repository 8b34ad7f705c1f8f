"""Learning-rate schedules (the JAX package's ``train/schedule.py``,
the reference's ``LearnSKDU``, Scheduler.hpp:25-173). Host-side floats:
the step count lives on the host in the port."""
from __future__ import annotations

import math


def lr_at(step, *, kind: str = "cosine", base_lr: float, total_steps: int,
          warmup: int = 0, min_ratio: float = 0.1, decay_frac: float = 0.1,
          epoch_steps: int = 0) -> float:
    """The lr at ``step`` (an int). ``cosine_epoch`` folds the step modulo
    ``epoch_steps`` and repeats the whole schedule, warmup included."""
    step = float(step)
    total = max(total_steps, 1)
    if kind == "cosine_epoch":
        total = max(epoch_steps, 1) if epoch_steps else total
        step = math.fmod(step, total)
    warm = min(step / max(warmup, 1), 1.0) if warmup else 1.0
    min_lr = base_lr * min_ratio
    if kind in ("static", "fix"):
        core = base_lr
    elif kind in ("cosine", "cosine_epoch"):
        t = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
        core = min_lr + 0.5 * (base_lr - min_lr) * (1 + math.cos(math.pi * t))
    elif kind == "wsd":   # warmup-stable-decay: hold, then a linear tail
        decay_start = total * (1.0 - decay_frac)
        t = min(max((step - decay_start) / max(total - decay_start, 1), 0.0),
                1.0)
        core = base_lr - (base_lr - min_lr) * t
    elif kind == "tri_line":   # triangular: up to the peak mid-run, down
        t = min(max(step / total, 0.0), 1.0)
        core = min_lr + (base_lr - min_lr) * (1 - abs(2 * t - 1))
    else:
        raise ValueError(f"unknown schedule {kind}")
    return core * warm
