"""Loader and wrapper of the Hopper SSD intra-chunk kernel.

The kernel (``csrc/ssd_intra_chunk.cu``) replaces the TPU kernel
``repro/kernels/ssd/ssd.py::ssd_intra_chunk``; its source says how.  It is
compiled for ``sm_90a`` on first use with the port's other kernels
(:mod:`..build`) and bound with ``ctypes``.

:func:`ssd_intra_chunk` takes CUDA tensors only and launches the kernel or
raises; the plain version for CPU tensors is
:func:`.ref.ssd_intra_chunk_ref`, and :mod:`.ops` picks between the two by
the tensors' device.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..build import kernel_fn

MAX_CHUNK = 1024
MAX_HEAD_DIM = 64
MAX_STATE_DIM = 128
# the kernel's schedule as compiled (ssd_intra_chunk.cu): kT rows a row or
# column tile, kG heads sharing one score tile
_TILE = 64
_GROUP = 4


@functools.cache
def _kernel():
    p, i = ctypes.c_void_p, ctypes.c_int
    return kernel_fn("ssd_intra_chunk_f32",
                     [p, p, p, p, p, p, p, i, i, i, i, i, i, p])


def ssd_intra_chunk(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                    b_mat: torch.Tensor, c_mat: torch.Tensor, *,
                    chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Intra-chunk SSD on the card.

    x: (B,S,H,P); dt: (B,S,H) (already softplus'd); a: (H,); b/c: (B,S,N)
    shared by all heads; all float32, contiguous, on one CUDA device, with
    S % chunk == 0, chunk ≤ 1024, P ≤ 64, N ≤ 128.  Returns
    (y_intra (B,S,H,P), states (B,nc,H,P,N)) in float32.  Adds one to
    ``ssd_intra_chunk.launches`` per kernel launch.
    """
    if x.device.type != "cuda":
        raise ValueError(
            f"ssd_intra_chunk: x is on {x.device}; the kernel takes CUDA "
            f"tensors (CPU tensors go to ref.ssd_intra_chunk_ref)")
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    for name, t, shape in (("x", x, (bsz, s, h, p)), ("dt", dt, (bsz, s, h)),
                           ("a", a, (h,)), ("b_mat", b_mat, (bsz, s, n)),
                           ("c_mat", c_mat, (bsz, s, n))):
        if t.device != x.device or t.dtype != torch.float32 \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"ssd_intra_chunk: {name} must be a contiguous float32 "
                f"tensor of shape {shape} on {x.device}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device} "
                f"contiguous={t.is_contiguous()}")
    if not 1 <= chunk <= MAX_CHUNK or s % chunk:
        raise ValueError(f"ssd_intra_chunk: chunk={chunk} must lie in "
                         f"[1, {MAX_CHUNK}] and divide S={s} (pad first)")
    if p > MAX_HEAD_DIM or n > MAX_STATE_DIM:
        raise ValueError(f"ssd_intra_chunk: P={p} > {MAX_HEAD_DIM} or "
                         f"N={n} > {MAX_STATE_DIM}")
    nc = s // chunk
    y = torch.empty_like(x)
    st = torch.empty(bsz, nc, h, p, n, dtype=torch.float32, device=x.device)
    if x.numel() == 0 or n == 0:
        return y, st.zero_()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _kernel()(x.data_ptr(), dt.data_ptr(), a.data_ptr(),
                    b_mat.data_ptr(), c_mat.data_ptr(), y.data_ptr(),
                    st.data_ptr(), bsz, s, h, p, n, chunk, stream)
    if err:
        raise RuntimeError(
            f"ssd_intra_chunk: kernel launch failed with cudaError {err} "
            f"(x {tuple(x.shape)}, N={n}, chunk={chunk})")
    ssd_intra_chunk.launches += 1
    return y, st


ssd_intra_chunk.launches = 0


def hbm_bytes_model(bsz: int, s: int, h: int, p: int, n: int, *,
                    chunk: int = 64, itemsize: int = 4) -> int:
    """Global-memory bytes the kernel's schedule requests for one call.

    Work is cut per (batch, chunk, group of 4 heads): one block per 64-row
    tile I of the chunk and one for the group's boundary states.  A
    row-tile block reads dt of the group's heads over the chunk, ``a``,
    C_I, and for every column tile J ≤ I the B_J rows and the heads' x_J
    rows, and writes the heads' y rows of I.  The state block reads dt and
    ``a`` again, x of every head and B once per pass of heads (4 heads a
    pass, 2 where N > 64), and writes the states.  Rows past the chunk
    and heads past H are not read.  Where the TPU kernel's schedule
    (``repro/kernels/ssd/ssd.py::hbm_bytes_model``: one program per
    (batch · head, chunk) reading x, dt, B, C once and writing y and the
    state) differs: B and C are read once per group of heads, not per
    head; B_J and x_J once per row tile at or below J (the triangle), and
    once more by the state block with dt; ``a`` once per block.  At one
    head and a chunk of one tile (64 rows) the port's bytes are the TPU
    model's plus the state block's second read of dt, B and x and the two
    reads of ``a``.
    """
    nc = -(-s // chunk)
    rows = [min(_TILE, chunk - t) for t in range(0, chunk, _TILE)]
    per_chunk = 0
    for h0 in range(0, h, _GROUP):
        hg = min(_GROUP, h - h0)
        for it, r_i in enumerate(rows):
            per_chunk += hg * chunk + hg + r_i * n + hg * r_i * p
            per_chunk += sum(rows[: it + 1]) * (n + hg * p)
        passes = -(-hg // (2 if n > 64 else 4))
        per_chunk += (hg * chunk + hg + passes * chunk * n
                      + hg * chunk * p + hg * p * n)
    return bsz * nc * per_chunk * itemsize
