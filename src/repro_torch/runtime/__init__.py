from . import collectives  # noqa: F401
from .mesh import TPMesh, padded_size  # noqa: F401
