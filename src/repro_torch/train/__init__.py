"""LM training on one device: the port of ``repro/train``."""
from .loop import make_loss_fn, make_train_step  # noqa: F401
from .state import TrainState, init_train_state  # noqa: F401
