"""Sharding rules of the port (``sharding/rules.py``)."""
from repro_torch.sharding.rules import (PartitionSpec,  # noqa: F401
                                        activation_mesh, batch_axes,
                                        cache_specs, current_mesh,
                                        param_specs, train_batch_specs,
                                        train_state_specs)
