from . import layers, models, train  # noqa: F401
from .models import GNNConfig, forward, init_params  # noqa: F401
