"""Plan-based SpMM aggregation with an exact backward.

:func:`block_sparse_plan_dev` takes a :class:`~repro_torch.graph.format
.BlockSparsePlan` (dense (bs × bs) tiles of Â and of Âᵀ, as the TPU kernel
reads them) and derives, once, on the plan's device, the compressed form
the CUDA kernel reads: per destination row the range of (global source
index, value) pairs of the tiles' nonzero entries (:func:`compress_tiles`).
The form is derived from the tiles themselves, so whatever they hold
(all-zero padding tiles of ``stack_plans`` included) is multiplied by
exactly that; skipping a zero entry is exact.

:func:`aggregate_plan` multiplies through the forward arrays, and its
backward multiplies the cotangent through the Âᵀ arrays with the same
kernel, so the gradient is exact (Â is constant data) and one kernel covers
both directions.  On CUDA tensors the kernel (:func:`.spmm.spmm_csr`)
runs, and a failure to build or launch raises; on CPU tensors the plain
version (:func:`.ref.spmm_csr_ref`) runs.  There is no other path.

Only static-weight aggregation (GCN's fixed Â) can use these arrays; GAT's
runtime attention weights cannot be baked in.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ...graph.format import BlockSparsePlan
from .ref import spmm_csr_ref
from .spmm import spmm_csr


@dataclasses.dataclass(frozen=True)
class BlockSparsePlanDev:
    """A :class:`BlockSparsePlan` in the kernel's compressed form, on a
    device: ``row_ptr`` (rows_padded + 1), ``col_idx`` (int32 source row)
    and ``vals`` (float32) for Â, and the ``*_t`` arrays for Âᵀ (rows
    cols_padded + 1).

    Arrays may carry one leading stack axis (chunks); ``col_idx``/``vals``
    are then padded to the largest instance, and the padding lies past
    each instance's ``row_ptr[-1]``.  :meth:`instance` takes one plan out
    of the stack."""

    row_ptr: torch.Tensor
    col_idx: torch.Tensor
    vals: torch.Tensor
    row_ptr_t: torch.Tensor
    col_idx_t: torch.Tensor
    vals_t: torch.Tensor
    n_rows: int
    n_cols: int
    rows_padded: int
    cols_padded: int
    bs: int

    def instance(self, c: int) -> "BlockSparsePlanDev":
        """Plan ``c`` of a stacked plan."""
        return dataclasses.replace(
            self, row_ptr=self.row_ptr[c], col_idx=self.col_idx[c],
            vals=self.vals[c], row_ptr_t=self.row_ptr_t[c],
            col_idx_t=self.col_idx_t[c], vals_t=self.vals_t[c])


def _check_tiles(rows: np.ndarray, cols: np.ndarray, n_row_blocks: int,
                 n_col_blocks: int, what: str) -> None:
    """Host-side bounds of a tile table: the derived indices address rows
    of h and of the output, which the kernel does not check."""
    if rows.size == 0:
        return
    if rows.min() < 0 or rows.max() >= n_row_blocks or \
            np.any(np.diff(rows, axis=-1) < 0):
        raise ValueError(f"block_sparse_plan_dev: {what} rows must be "
                         f"non-decreasing in [0, {n_row_blocks})")
    if cols.min() < 0 or cols.max() >= n_col_blocks:
        raise ValueError(f"block_sparse_plan_dev: {what} cols must lie in "
                         f"[0, {n_col_blocks})")


def compress_tiles(blocks: torch.Tensor, block_rows: torch.Tensor,
                   block_cols: torch.Tensor, n_out: int):
    """The nonzero entries of one plan instance's tiles as compressed rows.

    blocks (nnzb, bs, bs), block_rows/block_cols (nnzb,) → ``row_ptr``
    (n_out + 1,) int32, ``col_idx`` (nnz,) int32 global source rows and
    ``vals`` (nnz,) float32, the entries of each row in tile order (source
    block, then column).  Runs on the tiles' device."""
    bs = blocks.shape[-1]
    k, i, j = torch.nonzero(blocks, as_tuple=True)
    rows = block_rows.long()[k] * bs + i
    order = torch.argsort(rows, stable=True)
    k, i, j, rows = k[order], i[order], j[order], rows[order]
    if rows.numel() >= np.iinfo(np.int32).max:
        raise ValueError(f"block_sparse_plan_dev: {rows.numel()} nonzeros "
                         f"do not fit int32 row pointers")
    row_ptr = torch.zeros(n_out + 1, dtype=torch.int32, device=blocks.device)
    row_ptr[1:] = torch.cumsum(torch.bincount(rows, minlength=n_out), 0)
    col_idx = (block_cols.long()[k] * bs + j).to(torch.int32)
    return row_ptr, col_idx, blocks[k, i, j]


def _compress_stack(blocks: np.ndarray, rows: np.ndarray, cols: np.ndarray,
                    n_out: int, n_src: int, device, what: str):
    """:func:`compress_tiles` for each instance of a (possibly stacked)
    tile table, one instance's tiles on the device at a time; the stack's
    ``col_idx``/``vals`` are padded with zeros to the largest instance."""
    stacked = blocks.ndim == 4
    if not stacked:
        blocks, rows, cols = blocks[None], rows[None], cols[None]
    parts = []
    for c in range(blocks.shape[0]):
        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)
        parts.append(compress_tiles(dev(blocks[c]), dev(rows[c]),
                                    dev(cols[c]), n_out))
    cap = max(p[1].shape[0] for p in parts)
    hi = max((int(p[1].max()) for p in parts if p[1].numel()), default=-1)
    if hi >= n_src:
        raise ValueError(f"block_sparse_plan_dev: {what} tiles hold an "
                         f"entry in source row {hi} ≥ {n_src}")
    row_ptr = torch.stack([p[0] for p in parts])
    col_idx = torch.stack([F.pad(p[1], (0, cap - p[1].shape[0]))
                           for p in parts])
    vals = torch.stack([F.pad(p[2], (0, cap - p[2].shape[0]))
                        for p in parts])
    if not stacked:
        row_ptr, col_idx, vals = row_ptr[0], col_idx[0], vals[0]
    return row_ptr, col_idx, vals


def block_sparse_plan_dev(plan: BlockSparsePlan,
                          device: str | torch.device = "cuda"
                          ) -> BlockSparsePlanDev:
    r_blocks = plan.rows_padded // plan.bs
    c_blocks = plan.cols_padded // plan.bs
    _check_tiles(plan.block_rows, plan.block_cols, r_blocks, c_blocks,
                 "forward")
    _check_tiles(plan.block_rows_t, plan.block_cols_t, c_blocks, r_blocks,
                 "transposed")
    fwd = _compress_stack(plan.blocks, plan.block_rows, plan.block_cols,
                          plan.rows_padded, plan.n_cols, device, "forward")
    bwd = _compress_stack(plan.blocks_t, plan.block_rows_t,
                          plan.block_cols_t, plan.cols_padded, plan.n_rows,
                          device, "transposed")
    return BlockSparsePlanDev(
        row_ptr=fwd[0], col_idx=fwd[1], vals=fwd[2],
        row_ptr_t=bwd[0], col_idx_t=bwd[1], vals_t=bwd[2],
        n_rows=plan.n_rows, n_cols=plan.n_cols,
        rows_padded=plan.rows_padded, cols_padded=plan.cols_padded,
        bs=plan.bs)


def _run(row_ptr, col_idx, vals, h, n_src: int) -> torch.Tensor:
    """Zero-pad h to the ``n_src`` source rows the entries may address,
    then run the kernel (CUDA) or the plain version (CPU)."""
    n = h.shape[0]
    hp = h if n >= n_src else F.pad(h, (0, 0, 0, n_src - n))
    if hp.is_cuda:
        return spmm_csr(row_ptr, col_idx, vals, hp.contiguous())
    return spmm_csr_ref(row_ptr, col_idx, vals, hp)


class _PlanSpmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, plan: BlockSparsePlanDev):
        ctx.plan = plan
        ctx.n_in = h.shape[0]
        return _run(plan.row_ptr, plan.col_idx, plan.vals, h, plan.n_cols)

    @staticmethod
    def backward(ctx, gy):
        # grad_h = Âᵀ @ gy through the same kernel on the transposed arrays;
        # the caller sliced away the padded output rows, so their cotangent
        # rows are exact zeros.
        p = ctx.plan
        gh = _run(p.row_ptr_t, p.col_idx_t, p.vals_t, gy, p.n_rows)
        return gh[: ctx.n_in], None


def aggregate_plan(plan: BlockSparsePlanDev, h: torch.Tensor) -> torch.Tensor:
    """One plan instance: ``(rows_padded, d) = Â_plan @ h`` with the exact
    backward through the transposed arrays.  ``h`` is (n_in, d) with
    n_in ≤ cols_padded (missing source rows are zeros); the caller slices
    the real output rows (``[:plan.n_rows]``)."""
    return _PlanSpmm.apply(h, plan)
