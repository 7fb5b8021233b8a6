"""Plain PyTorch versions of the SpMM.

:func:`spmm_ref` multiplies through the dense block tiles, as the TPU
kernel does; :func:`spmm_csr_ref` through the compressed form that
:func:`repro_torch.kernels.spmm.ops.block_sparse_plan_dev` derives from the
same tiles, as the CUDA kernel does.  ``spmm_csr_ref`` is the CPU path of
:func:`repro_torch.kernels.spmm.ops.aggregate_plan` and
:func:`~repro_torch.kernels.spmm.ops.aggregate_pallas`; ``chip_smoke.py``
holds the CUDA kernel against both on the card.  :func:`spmm_dense_ref`
is the dense oracle of small graphs.
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


def spmm_csr_ref(row_ptr: torch.Tensor, col_idx: torch.Tensor,
                 vals: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """out[r] = Σ_{e ∈ [row_ptr[r], row_ptr[r+1])} vals[e] · h[col_idx[e]].

    ``row_ptr`` is (n_out + 1,); ``col_idx``/``vals`` may run past
    ``row_ptr[-1]`` (a stacked plan's padding), which is ignored.  A gather
    and one ``index_add_``, in fp32 where h is narrower (bf16), as the
    kernel sums, rounded to h's dtype once.  Returns (n_out, d)."""
    n_out = row_ptr.shape[0] - 1
    nnz = int(row_ptr[-1])
    rows = torch.repeat_interleave(
        torch.arange(n_out, device=h.device), row_ptr.diff().long(),
        output_size=nnz)
    hf = h.to(torch.promote_types(h.dtype, torch.float32))
    contrib = vals[:nnz, None] * hf.index_select(0, col_idx[:nnz].long())
    return hf.new_zeros(n_out, h.shape[1]).index_add_(0, rows, contrib) \
        .to(h.dtype)


def spmm_dense_ref(dense_a: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Fully dense oracle (small graphs only): the fp32 product
    ``dense_a @ h``, rounded to h's dtype."""
    return (dense_a.float() @ h.float()).to(h.dtype)
