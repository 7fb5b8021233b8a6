from .adamw import adamw, sgd, OptState, Optimizer, apply_updates  # noqa: F401
from .schedule import (constant, cosine_decay, linear_warmup_cosine)  # noqa: F401
