"""Learning-rate schedules (the JAX package's ``optim/schedule.py``)."""
from __future__ import annotations

import numpy as np


def warmup_cosine(step, *, peak_lr: float, warmup_steps: int,
                  total_steps: int, final_frac: float = 0.1) -> float:
    """Linear warmup to ``peak_lr``, then cosine decay to
    ``final_frac * peak_lr`` at ``total_steps``; computed in fp32 as the
    reference does."""
    f = np.float32
    s = f(step)
    peak = f(peak_lr)
    warm = peak * s / f(max(1, warmup_steps))
    prog = np.clip((s - f(warmup_steps))
                   / f(max(1, total_steps - warmup_steps)), f(0), f(1))
    cos = peak * (f(final_frac) + f(1 - final_frac) * f(0.5)
                  * (f(1) + np.cos(f(np.pi) * prog)))
    return float(warm if s < warmup_steps else cos)
