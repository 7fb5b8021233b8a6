"""Loader and wrapper of the Hopper nonzero-balanced SpMM kernel.

The kernel (``csrc/spmm_csr.cu``) replaces the TPU kernel
``repro/kernels/spmm/spmm.py::spmm_block_sparse``; it reads the compressed
form (row pointers, source indices, values) that :mod:`.ops` derives from
the block tiles, splits the work by nonzeros across warps, and the warp
in which a row that straddles several warps' segments ends adds their
parts in a fixed order; its source says how.  h and the output are fp32
or bf16 (one C entry point each, picked by h's dtype); the sums are fp32
and a bf16 output is rounded once.  It is compiled for ``sm_90a`` on first
use, alone (:mod:`..build`), and bound with ``ctypes``.

:func:`spmm_csr` takes CUDA tensors only and launches the kernel or
raises; the plain version for CPU tensors is :func:`..ref.spmm_csr_ref`,
and :mod:`.ops` picks between the two by the tensors' device.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..build import SPMM, kernel_fn


_ENTRIES = {torch.float32: "spmm_csr_f32", torch.bfloat16: "spmm_csr_bf16"}


@functools.cache
def _kernel(dtype: torch.dtype):
    p, i = ctypes.c_void_p, ctypes.c_int
    return kernel_fn(SPMM, _ENTRIES[dtype], [p, p, p, i, p, i, p, p, p, i, p])


def reset_launches() -> None:
    """Set the launch counts (total and per dtype of h) to 0."""
    spmm_csr.launches = 0
    spmm_csr.launches_by_dtype = {str(t).removeprefix("torch."): 0
                                  for t in _ENTRIES}


@functools.cache
def _segment() -> int:
    """Nonzeros per warp segment, as the kernel was compiled."""
    return kernel_fn(SPMM, "spmm_csr_segment", [])()


@functools.cache
def _tile_cols(d: int) -> int:
    """Columns per y-tile of the launch at width d."""
    return kernel_fn(SPMM, "spmm_csr_tile_cols", [ctypes.c_int])(d)


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int,
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(
            f"spmm_csr: {name} is on {t.device}, expected {device} (the "
            f"kernel takes CUDA tensors; CPU tensors go to ref.spmm_csr_ref)")
    if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(
            f"spmm_csr: {name} must be a contiguous {ndim}-d {dtype} tensor, "
            f"got {t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}")


def spmm_csr(row_ptr: torch.Tensor, col_idx: torch.Tensor,
             vals: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """out = A @ h on the card, A in compressed rows.

    row_ptr : (n_out + 1,) int32, row_ptr[0] = 0, non-decreasing
    col_idx : (cap,) int32 source rows < h.shape[0]; entries past
              row_ptr[-1] ≤ cap are ignored (a stacked plan's padding)
    vals    : (cap,) float32
    h       : (n_in, d) float32 or bfloat16, any d

    Every argument must lie on the same CUDA device; the indices are not
    checked on the card (``ops.block_sparse_plan_dev`` checks them once at
    upload).  Returns (n_out, d) in h's dtype (fp32 sums; bf16 rounded
    once), bitwise the same from run to run.  Adds one to
    ``spmm_csr.launches`` and to h's dtype's entry of
    ``spmm_csr.launches_by_dtype`` (keyed ``"float32"``, ``"bfloat16"``)
    per launch; ``cap == 0`` launches nothing and returns zeros.
    """
    if h.device.type != "cuda":
        raise ValueError(
            f"spmm_csr: h is on {h.device}; the kernel takes CUDA tensors "
            f"(CPU tensors go to ref.spmm_csr_ref)")
    _check("row_ptr", row_ptr, torch.int32, 1, h.device)
    _check("col_idx", col_idx, torch.int32, 1, h.device)
    _check("vals", vals, torch.float32, 1, h.device)
    if h.dtype not in _ENTRIES:
        raise ValueError(f"spmm_csr: h must be float32 or bfloat16, got "
                         f"{h.dtype}")
    _check("h", h, h.dtype, 2, h.device)
    n_out, cap, d = row_ptr.shape[0] - 1, col_idx.shape[0], h.shape[1]
    if n_out < 0 or vals.shape[0] != cap:
        raise ValueError(
            f"spmm_csr: row_ptr has {row_ptr.shape[0]} entries (need ≥ 1), "
            f"col_idx {cap} and vals {vals.shape[0]}")
    if h.numel() >= 2 ** 31:
        raise ValueError(f"spmm_csr: h {tuple(h.shape)} has 2^31 or more "
                         f"entries; the kernel indexes it with int32")
    if cap == 0 or n_out == 0 or d == 0:
        return h.new_zeros(n_out, d)
    n_seg = max(-(-cap // _segment()), 1)
    ny = -(-d // _tile_cols(d))
    out = torch.empty(n_out, d, dtype=h.dtype, device=h.device)
    carry = torch.empty(ny * n_seg * d, dtype=torch.float32, device=h.device)
    # zeroed by the C entry point on the same stream before the kernel
    flags = torch.empty(1 + ny * n_seg, dtype=torch.int32, device=h.device)
    err = _kernel(h.dtype)(
        row_ptr.data_ptr(), col_idx.data_ptr(), vals.data_ptr(), n_out,
        h.data_ptr(), d, out.data_ptr(), carry.data_ptr(), flags.data_ptr(),
        n_seg, torch.cuda.current_stream(h.device).cuda_stream)
    if err:
        raise RuntimeError(
            f"spmm_csr: kernel launch failed with cudaError {err} "
            f"(n_out={n_out}, cap={cap}, d={d})")
    spmm_csr.launches += 1
    spmm_csr.launches_by_dtype[str(h.dtype).removeprefix("torch.")] += 1
    return out


reset_launches()
