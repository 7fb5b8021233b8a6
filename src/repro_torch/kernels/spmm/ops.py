"""Plan-based block-sparse aggregation with an exact backward.

:class:`BlockSparsePlanDev` holds a :class:`~repro_torch.graph.format
.BlockSparsePlan` on a device: forward tiles and the transposed tiles.
:func:`aggregate_plan` multiplies through the forward tiles, and its
backward multiplies the cotangent through the Âᵀ tiles with the same
kernel, so the gradient is exact (Â is constant data) and one kernel covers
both directions.

On CUDA tensors the kernel (:func:`.spmm.spmm_block_sparse`) runs, and a
failure to build or launch raises; on CPU tensors the plain version
(:func:`.ref.spmm_ref`) runs.  There is no other path.

Only static-weight aggregation (GCN's fixed Â) can use these tiles; GAT's
runtime attention weights cannot be baked in.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ...graph.format import BlockSparsePlan
from .ref import spmm_ref
from .spmm import spmm_block_sparse


@dataclasses.dataclass(frozen=True)
class BlockSparsePlanDev:
    """Device mirror of :class:`BlockSparsePlan`.

    Tensors may carry one leading stack axis (chunks); :meth:`instance`
    takes one plan out of the stack.  ``row_first`` is not carried: the
    kernel and the plain version both sum over each destination row's
    tile range, which needs only the sorted ``block_rows``."""

    blocks: torch.Tensor
    block_rows: torch.Tensor
    block_cols: torch.Tensor
    blocks_t: torch.Tensor
    block_rows_t: torch.Tensor
    block_cols_t: torch.Tensor
    n_rows: int
    n_cols: int
    rows_padded: int
    cols_padded: int
    bs: int

    @property
    def nnzb(self) -> int:
        return int(self.block_rows.shape[-1])

    def instance(self, c: int) -> "BlockSparsePlanDev":
        """Plan ``c`` of a stacked plan."""
        return dataclasses.replace(
            self, blocks=self.blocks[c], block_rows=self.block_rows[c],
            block_cols=self.block_cols[c], blocks_t=self.blocks_t[c],
            block_rows_t=self.block_rows_t[c],
            block_cols_t=self.block_cols_t[c])


def _check_tiles(rows: np.ndarray, cols: np.ndarray, n_row_blocks: int,
                 n_col_blocks: int, what: str) -> None:
    """Host-side bounds of a tile table: the kernel reads source blocks
    and walks row ranges by these indices without checking them."""
    if rows.size == 0:
        return
    if rows.min() < 0 or rows.max() >= n_row_blocks or \
            np.any(np.diff(rows, axis=-1) < 0):
        raise ValueError(f"block_sparse_plan_dev: {what} rows must be "
                         f"non-decreasing in [0, {n_row_blocks})")
    if cols.min() < 0 or cols.max() >= n_col_blocks:
        raise ValueError(f"block_sparse_plan_dev: {what} cols must lie in "
                         f"[0, {n_col_blocks})")


def block_sparse_plan_dev(plan: BlockSparsePlan,
                          device: str | torch.device = "cuda"
                          ) -> BlockSparsePlanDev:
    r_blocks = plan.rows_padded // plan.bs
    c_blocks = plan.cols_padded // plan.bs
    _check_tiles(plan.block_rows, plan.block_cols, r_blocks, c_blocks,
                 "forward")
    _check_tiles(plan.block_rows_t, plan.block_cols_t, c_blocks, r_blocks,
                 "transposed")

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return BlockSparsePlanDev(
        blocks=dev(plan.blocks), block_rows=dev(plan.block_rows),
        block_cols=dev(plan.block_cols), blocks_t=dev(plan.blocks_t),
        block_rows_t=dev(plan.block_rows_t),
        block_cols_t=dev(plan.block_cols_t),
        n_rows=plan.n_rows, n_cols=plan.n_cols,
        rows_padded=plan.rows_padded, cols_padded=plan.cols_padded,
        bs=plan.bs)


def _run_tiles(blocks, rows, cols, h, n_in_padded: int,
               n_out: int) -> torch.Tensor:
    """Pad h's rows to ``n_in_padded`` and run: (n_out, d) out.

    The kernel takes any d, so the feature dim is not padded."""
    n = h.shape[0]
    hp = h if n == n_in_padded else F.pad(h, (0, 0, 0, n_in_padded - n))
    if hp.is_cuda:
        return spmm_block_sparse(blocks, rows, cols, hp.contiguous(),
                                 n_out=n_out)
    return spmm_ref(blocks, rows, cols, hp, n_out=n_out)


class _PlanSpmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, plan: BlockSparsePlanDev):
        ctx.plan = plan
        ctx.n_in = h.shape[0]
        return _run_tiles(plan.blocks, plan.block_rows, plan.block_cols, h,
                          plan.cols_padded, plan.rows_padded)

    @staticmethod
    def backward(ctx, gy):
        # grad_h = Âᵀ @ gy through the same kernel on the transposed tiles;
        # the caller sliced away the padded output rows, so their cotangent
        # rows are exact zeros.
        p = ctx.plan
        gh = _run_tiles(p.blocks_t, p.block_rows_t, p.block_cols_t, gy,
                        p.rows_padded, p.cols_padded)
        return gh[: ctx.n_in], None


def aggregate_plan(plan: BlockSparsePlanDev, h: torch.Tensor) -> torch.Tensor:
    """One plan instance: ``(rows_padded, d) = Â_plan @ h`` with the exact
    backward through the transposed tiles.  ``h`` is (n_in, d) with
    n_in ≤ cols_padded (rows are zero-padded internally); the caller
    slices the real output rows (``[:plan.n_rows]``)."""
    return _PlanSpmm.apply(h, plan)
