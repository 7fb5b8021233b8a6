from . import layers, models  # noqa: F401
from .models import GNNConfig, init_params  # noqa: F401
