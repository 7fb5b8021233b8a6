"""SpMM aggregation on the kernel's compressed rows: plans with an exact
backward, and one-shot forward products.

Two device-side containers, as in the JAX package:

* :class:`BlockSparsePlanDev` — forward and transposed arrays of a plan;
  :func:`aggregate_plan` through it carries an exact backward.
* :class:`BlockSparseDev` — the forward arrays of a whole-graph
  :class:`~repro_torch.graph.format.BlockSparseGraph` only
  (:func:`block_sparse_dev`): one-shot aggregation and kernel timing,
  forward only.  :func:`square_plan_dev` builds a square plan of Â and Âᵀ
  from the same graph where a gradient is needed, and
  :func:`aggregate_pallas` takes either.

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

The out-of-core epoch (:mod:`repro_torch.core.stream`) stages one
direction of one chunk at a time, a :class:`HalfPlan` (:func:`half_plans`
builds both of a plan), and multiplies through it forward only
(:func:`spmm_half`): it runs the transpose itself, on the transposed half
plan, with no autograd through the kernel.

Only static-weight aggregation (GCN's fixed Â) can use these arrays; GAT's
runtime attention weights cannot be baked in.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ...graph.format import (BlockSparseGraph, BlockSparsePlan,
                             block_sparse_transpose)
from .. import refuse_fake
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
    of the stack.

    A plan of 1 × 1 tiles (``bs = 1``, nothing padded) is a matrix's
    compressed rows as they are: :func:`repro_torch.core.agg.csr_plan`
    derives one from the chunked edge lists."""

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
                    n_out: int, n_src: int, device, what: str,
                    dtype: torch.dtype = torch.float32):
    """:func:`compress_tiles` for each instance of a (possibly stacked)
    tile table, one instance's tiles on the device at a time, their values
    rounded through ``dtype`` and held as float32; the stack's
    ``col_idx``/``vals`` are padded with zeros to the largest instance."""
    stacked = blocks.ndim == 4
    if not stacked:
        blocks, rows, cols = blocks[None], rows[None], cols[None]
    parts = []
    for c in range(blocks.shape[0]):
        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)
        tiles = dev(blocks[c]).to(dtype).float()
        parts.append(compress_tiles(tiles, dev(rows[c]), dev(cols[c]),
                                    n_out))
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


def _compress_plan(plan: BlockSparsePlan, device,
                   dtype: torch.dtype = torch.float32):
    """The forward and the transposed compressed arrays of ``plan``."""
    r_blocks = plan.rows_padded // plan.bs
    c_blocks = plan.cols_padded // plan.bs
    _check_tiles(plan.block_rows, plan.block_cols, r_blocks, c_blocks,
                 "forward")
    _check_tiles(plan.block_rows_t, plan.block_cols_t, c_blocks, r_blocks,
                 "transposed")
    fwd = _compress_stack(plan.blocks, plan.block_rows, plan.block_cols,
                          plan.rows_padded, plan.n_cols, device, "forward",
                          dtype)
    bwd = _compress_stack(plan.blocks_t, plan.block_rows_t,
                          plan.block_cols_t, plan.cols_padded, plan.n_rows,
                          device, "transposed", dtype)
    return fwd, bwd


def block_sparse_plan_dev(plan: BlockSparsePlan,
                          device: str | torch.device = "cuda",
                          dtype: torch.dtype = torch.float32
                          ) -> BlockSparsePlanDev:
    """``plan`` on ``device`` in the kernel's compressed form, the tile
    values rounded through ``dtype`` (the JAX package's tile dtype) and
    held as float32: a bf16 value is exact in fp32, so bf16 tiles multiply
    exactly what the reference's bf16 tiles multiply."""
    fwd, bwd = _compress_plan(plan, device, dtype)
    return BlockSparsePlanDev(
        row_ptr=fwd[0], col_idx=fwd[1], vals=fwd[2],
        row_ptr_t=bwd[0], col_idx_t=bwd[1], vals_t=bwd[2],
        n_rows=plan.n_rows, n_cols=plan.n_cols,
        rows_padded=plan.rows_padded, cols_padded=plan.cols_padded,
        bs=plan.bs)


@dataclasses.dataclass(frozen=True)
class HalfPlan:
    """One direction of one plan instance in the kernel's compressed form:
    ``row_ptr`` (n_out + 1,) int32, and ``col_idx`` (int32) and ``vals``
    (float32) of exactly its ``row_ptr[-1]`` nonzeros, over ``n_src``
    source rows.  The transposed half plan is a forward plan of the
    transposed rectangle: its rows are the forward plan's padded columns,
    its sources the forward plan's rows."""

    row_ptr: torch.Tensor
    col_idx: torch.Tensor
    vals: torch.Tensor
    n_src: int


def half_plans(plan: BlockSparsePlan, device: str | torch.device = "cuda"
               ) -> tuple[HalfPlan, HalfPlan]:
    """The forward and the transposed half plan of one (unstacked) plan,
    on ``device``: the arrays :func:`block_sparse_plan_dev` derives for
    it, with the same checks."""
    if plan.blocks.ndim != 3:
        raise ValueError("half_plans takes one plan, not a stack; take "
                         "each chunk's plan from graph.format.chunk_plans")
    fwd, bwd = _compress_plan(plan, device)
    return HalfPlan(*fwd, n_src=plan.n_cols), HalfPlan(*bwd,
                                                       n_src=plan.n_rows)


def _run(row_ptr, col_idx, vals, h, n_src: int) -> torch.Tensor:
    """Zero-pad h to the ``n_src`` source rows the entries may address,
    then run the kernel (CUDA) or the plain version (CPU)."""
    refuse_fake("spmm_csr", h, vals)
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


def spmm_half(plan: HalfPlan, h: torch.Tensor) -> torch.Tensor:
    """``(n_out, d) = A @ h`` through one half plan, forward only: the
    kernel on CUDA tensors, the plain version on CPU tensors.  ``h`` is
    (n_in, d) with n_in ≤ its source rows (missing rows are zeros)."""
    return _run(plan.row_ptr, plan.col_idx, plan.vals, h, plan.n_src)


@dataclasses.dataclass(frozen=True)
class BlockSparseDev:
    """The forward tiles of a whole-graph :class:`BlockSparseGraph` in the
    kernel's compressed form, on a device: ``row_ptr`` (n_padded + 1),
    ``col_idx`` (int32 source row < n_padded) and ``vals`` (float32).
    Forward only: :func:`aggregate_pallas` refuses a gradient through it
    (:func:`square_plan_dev` carries one)."""

    row_ptr: torch.Tensor
    col_idx: torch.Tensor
    vals: torch.Tensor
    n: int
    n_padded: int
    bs: int


def block_sparse_dev(bsg: BlockSparseGraph, dtype: torch.dtype = torch.float32,
                     device: str | torch.device = "cuda") -> BlockSparseDev:
    """``bsg``'s forward tiles on ``device`` (the card unless the caller
    asks for the CPU), their values rounded through ``dtype`` and held as
    float32, derived once by :func:`compress_tiles` with the plans' checks:
    tiles within the (n_padded / bs)² grid, rows non-decreasing, and every
    entry's source row below ``n_padded`` (h is zero-padded to it)."""
    n_blocks = bsg.n_padded // bsg.bs
    _check_tiles(bsg.block_rows, bsg.block_cols, n_blocks, n_blocks,
                 "forward")
    row_ptr, col_idx, vals = _compress_stack(
        bsg.blocks, bsg.block_rows, bsg.block_cols, bsg.n_padded,
        bsg.n_padded, device, "forward", dtype)
    return BlockSparseDev(row_ptr=row_ptr, col_idx=col_idx, vals=vals,
                          n=bsg.n, n_padded=bsg.n_padded, bs=bsg.bs)


def square_plan_dev(bsg: BlockSparseGraph, dtype: torch.dtype = torch.float32,
                    device: str | torch.device = "cuda"
                    ) -> BlockSparsePlanDev:
    """The full-graph (square Â) plan of ``bsg``: its forward tiles and
    Âᵀ's (:func:`~repro_torch.graph.format.block_sparse_transpose`) for the
    exact backward, as :func:`block_sparse_plan_dev` derives them."""
    t = block_sparse_transpose(bsg)
    plan = BlockSparsePlan(
        n_rows=bsg.n, n_cols=bsg.n, rows_padded=bsg.n_padded,
        cols_padded=bsg.n_padded, bs=bsg.bs, block_rows=bsg.block_rows,
        block_cols=bsg.block_cols, row_first=bsg.row_first,
        blocks=bsg.blocks, block_rows_t=t.block_rows,
        block_cols_t=t.block_cols, row_first_t=t.row_first, blocks_t=t.blocks)
    return block_sparse_plan_dev(plan, device, dtype)


def aggregate_pallas(bsg: BlockSparseDev | BlockSparsePlanDev,
                     h: torch.Tensor) -> torch.Tensor:
    """Â @ h for the (n, d) features h (fp32 or bf16; a bf16 result is the
    fp32 sum rounded once).

    Given a :class:`BlockSparsePlanDev` (square), the product carries the
    exact backward of :func:`aggregate_plan`.  Given a
    :class:`BlockSparseDev`, it is forward only: h is zero-padded to
    ``n_padded`` rows, multiplied, and the first n rows returned; under
    grad mode with an h that requires grad it raises, as the JAX package's
    ``jax.grad`` through the kernel does.  CUDA tensors go to the kernel
    (a failure raises), CPU tensors to the plain version.

    Only static-weight aggregation can use these arrays (module
    docstring)."""
    n = h.shape[0]
    if isinstance(bsg, BlockSparsePlanDev):
        return aggregate_plan(bsg, h)[:n]
    if torch.is_grad_enabled() and h.requires_grad:
        raise RuntimeError(
            "aggregate_pallas on a BlockSparseDev has no backward: it holds "
            "Â's tiles only, and no kernel differentiates through them. "
            "Build the graph with square_plan_dev(bsg), whose Âᵀ arrays "
            "carry the exact gradient, or call it under torch.no_grad().")
    return _run(bsg.row_ptr, bsg.col_idx, bsg.vals, h, bsg.n_padded)[:n]
