from .ops import ssd_chunked_fused  # noqa: F401
from .ref import ssd_dense_ref, ssd_intra_chunk_ref  # noqa: F401
from .ssd import ssd_intra_chunk  # noqa: F401
