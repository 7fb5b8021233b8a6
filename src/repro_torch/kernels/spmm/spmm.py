"""Loader and wrapper of the Hopper block-sparse SpMM kernel.

The kernel (``csrc/spmm_block_sparse.cu``) replaces the TPU kernel
``repro/kernels/spmm/spmm.py::spmm_block_sparse``; its source says how.
It is compiled for ``sm_90a`` on first use with the port's other kernels
(:mod:`..build`) and bound with ``ctypes``.

:func:`spmm_block_sparse` takes CUDA tensors only and launches the kernel or
raises; the plain version for CPU tensors is :func:`..ref.spmm_ref`, and
:mod:`.ops` picks between the two by the tensors' device.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..build import kernel_fn

BLOCK_SIZES = (32, 64, 128)


@functools.cache
def _kernel():
    return kernel_fn("spmm_block_sparse_f32",
                     [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                      ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                      ctypes.c_void_p])


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int,
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(
            f"spmm_block_sparse: {name} is on {t.device}, expected {device} "
            f"(the kernel takes CUDA tensors; CPU tensors go to "
            f"ref.spmm_ref)")
    if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(
            f"spmm_block_sparse: {name} must be a contiguous {ndim}-d "
            f"{dtype} tensor, got {t.dtype} {tuple(t.shape)} "
            f"contiguous={t.is_contiguous()}")


def spmm_block_sparse(blocks: torch.Tensor, block_rows: torch.Tensor,
                      block_cols: torch.Tensor, h: torch.Tensor, *,
                      n_out: int | None = None) -> torch.Tensor:
    """out = A @ h with A given as sorted block tiles, on the card.

    blocks     : (nnzb, bs, bs) float32, bs ∈ {32, 64, 128}
    block_rows : (nnzb,) int32 non-decreasing destination block ids
    block_cols : (nnzb,) int32 source block ids, < n_padded // bs
    h          : (n_padded, d) float32 with n_padded % bs == 0, any d
    n_out      : output rows (multiple of bs); defaults to n_padded.

    Every argument must lie on the same CUDA device.  Adds one to
    ``spmm_block_sparse.launches`` per kernel launch; ``nnzb == 0``
    launches nothing and returns zeros.
    """
    if h.device.type != "cuda":
        raise ValueError(
            f"spmm_block_sparse: h is on {h.device}; the kernel takes CUDA "
            f"tensors (CPU tensors go to ref.spmm_ref)")
    _check("blocks", blocks, torch.float32, 3, h.device)
    _check("block_rows", block_rows, torch.int32, 1, h.device)
    _check("block_cols", block_cols, torch.int32, 1, h.device)
    _check("h", h, torch.float32, 2, h.device)
    nnzb, bs, bs2 = blocks.shape
    n_padded, d = h.shape
    n_out = n_padded if n_out is None else n_out
    if bs != bs2 or bs not in BLOCK_SIZES:
        raise ValueError(f"spmm_block_sparse: tiles are {bs}x{bs2}; the "
                         f"kernel takes square tiles of bs in {BLOCK_SIZES}")
    if block_rows.shape[0] != nnzb or block_cols.shape[0] != nnzb:
        raise ValueError(
            f"spmm_block_sparse: {nnzb} tiles but {block_rows.shape[0]} "
            f"rows and {block_cols.shape[0]} cols")
    if n_padded % bs:
        raise ValueError(
            f"spmm_block_sparse: h has {n_padded} rows, not a multiple of "
            f"the block size bs={bs} — pad the source rows first")
    if n_out % bs:
        raise ValueError(
            f"spmm_block_sparse: n_out={n_out} is not a multiple of the "
            f"block size bs={bs}")
    if nnzb == 0 or n_out == 0 or d == 0:
        return h.new_zeros(n_out, d)
    out = torch.empty(n_out, d, dtype=h.dtype, device=h.device)
    stream = torch.cuda.current_stream(h.device).cuda_stream
    err = _kernel()(
        blocks.data_ptr(), block_rows.data_ptr(), block_cols.data_ptr(),
        nnzb, bs, h.data_ptr(), d, out.data_ptr(), n_out // bs, stream)
    if err:
        raise RuntimeError(
            f"spmm_block_sparse: kernel launch failed with cudaError {err} "
            f"(nnzb={nnzb}, bs={bs}, d={d}, n_out={n_out})")
    spmm_block_sparse.launches += 1
    return out


spmm_block_sparse.launches = 0
