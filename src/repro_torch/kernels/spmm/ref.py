"""Plain PyTorch version of the block-sparse SpMM kernel.

The CPU path of :func:`repro_torch.kernels.spmm.ops.aggregate_plan`, and
the version ``chip_smoke.py`` holds the CUDA kernel against on the card.
"""
from __future__ import annotations

import torch


def spmm_ref(blocks: torch.Tensor, block_rows: torch.Tensor,
             block_cols: torch.Tensor, h: torch.Tensor,
             n_out: int | None = None) -> torch.Tensor:
    """out[r] = Σ_k [rows[k]==r] blocks[k] @ h_block[cols[k]]   (dense math).

    Independent of the kernel's scheduling: gathers source blocks, does one
    batched matmul, and ``index_add``s per destination block.  ``h`` is
    (n_padded, d) with n_padded % bs == 0; ``n_out`` (a multiple of bs)
    sets the output rows for rectangular A slices.
    """
    nnzb, bs, _ = blocks.shape
    n_padded, d = h.shape
    n_out = n_padded if n_out is None else n_out
    h_blocked = h.reshape(n_padded // bs, bs, d)
    contribs = torch.bmm(blocks, h_blocked.index_select(0, block_cols))
    out = h.new_zeros(n_out // bs, bs, d).index_add(0, block_rows, contribs)
    return out.reshape(n_out, d)
