from .ops import (BlockSparsePlanDev, HalfPlan, block_sparse_plan_dev,
                  aggregate_plan, compress_tiles, half_plans,
                  spmm_half)  # noqa: F401
from .ref import spmm_csr_ref, spmm_ref  # noqa: F401
from .spmm import spmm_csr  # noqa: F401
