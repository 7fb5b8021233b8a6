"""LM training, on one device or sharded: the port of ``repro/train``."""
from .loop import (batch_shardings, batch_spec, make_grad_fn,  # noqa: F401
                   make_loss_fn, make_train_step, sharded_setup)
from .state import (TrainState, init_sharded_state,  # noqa: F401
                    init_train_state)
