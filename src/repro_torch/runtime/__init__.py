from . import collectives, streaming, telemetry  # noqa: F401
from .mesh import TPMesh, padded_size  # noqa: F401
