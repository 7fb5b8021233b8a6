from .ops import (BlockSparsePlanDev, block_sparse_plan_dev,
                  aggregate_plan, compress_tiles)  # noqa: F401
from .ref import spmm_csr_ref, spmm_ref  # noqa: F401
from .spmm import spmm_csr  # noqa: F401
