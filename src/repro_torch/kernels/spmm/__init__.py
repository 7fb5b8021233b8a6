from .ops import (BlockSparseDev, BlockSparsePlanDev, HalfPlan,
                  aggregate_pallas, aggregate_plan, block_sparse_dev,
                  block_sparse_plan_dev, compress_tiles, half_plans,
                  spmm_half, square_plan_dev)  # noqa: F401
from .ref import spmm_csr_ref, spmm_dense_ref, spmm_ref  # noqa: F401
from .spmm import spmm_csr  # noqa: F401
