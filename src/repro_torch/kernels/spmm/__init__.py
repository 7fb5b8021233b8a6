from .ops import (BlockSparsePlanDev, block_sparse_plan_dev,
                  aggregate_plan)  # noqa: F401
from .ref import spmm_ref  # noqa: F401
from .spmm import spmm_block_sparse  # noqa: F401
