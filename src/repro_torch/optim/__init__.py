"""Optimizer and learning-rate schedule of the port."""
from repro_torch.optim.adamw import (AdamState, adamw_init,  # noqa: F401
                                     adamw_update, clip_by_global_norm,
                                     global_norm)
from repro_torch.optim.schedule import warmup_cosine  # noqa: F401
