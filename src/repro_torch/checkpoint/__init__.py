"""Checkpointing of the port."""
from repro_torch.checkpoint.checkpoint import (Checkpointer,  # noqa: F401
                                               latest_step, restore, save)
