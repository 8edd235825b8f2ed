"""Training step of the port."""
from repro_torch.train.step import (TrainHParams, TrainState,  # noqa: F401
                                    init_train_state, make_train_step,
                                    microbatch_grads)
