"""Learning-rate schedules (the JAX package's ``optim/schedule.py``)."""
from __future__ import annotations

import math
from typing import Union

import torch


def warmup_cosine(step: Union[int, torch.Tensor], *, peak_lr: float,
                  warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1) -> Union[float, torch.Tensor]:
    """Linear warmup to ``peak_lr``, then cosine decay to
    ``final_frac * peak_lr`` at ``total_steps``, in fp32 op for op as the
    reference computes it.  A 0-dim integer tensor ``step`` gives a 0-dim
    fp32 tensor on its device (nothing is read back to the host: a
    captured train step computes its rate from the step it holds); an
    ``int`` gives a float."""
    if not isinstance(step, torch.Tensor):
        return float(warmup_cosine(torch.tensor(step, dtype=torch.int32),
                                   peak_lr=peak_lr, warmup_steps=warmup_steps,
                                   total_steps=total_steps,
                                   final_frac=final_frac))
    s = step.to(torch.float32)
    warm = peak_lr * s / max(1, warmup_steps)
    prog = torch.clamp((s - warmup_steps)
                       / max(1, total_steps - warmup_steps), 0.0, 1.0)
    # the reference's Python constants fold in double before meeting fp32
    cos = peak_lr * (final_frac + (1 - final_frac) * 0.5
                     * (1 + torch.cos(math.pi * prog)))
    return torch.where(s < warmup_steps, warm, cos)
