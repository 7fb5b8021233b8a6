from . import collectives, distributed, streaming, telemetry  # noqa: F401
from .mesh import (TPMesh, hybrid_mesh, padded_size,  # noqa: F401
                   resolve_bundle_degrees, resolve_mesh_shape,
                   resolve_replicas)
