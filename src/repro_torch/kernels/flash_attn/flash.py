"""Loader and wrapper of the Hopper flash-attention kernels.

Two kernels replace the TPU kernel
``repro/kernels/flash_attn/flash.py::flash_attention_bhsd``, one per input
type, both on the tensor cores: bf16 (every launch of the model paths) in
``csrc/flash_attention_mma.cu`` (variant ``"mma_bf16"``), fp32 in
``csrc/flash_attention_tf32x3.cu`` (variant ``"mma_tf32x3"``), whose
products are three TF32 passes of a hi/lo split of each operand, accurate
to about 2^-22, where one TF32 pass misses fp32's 1e-5.  Their sources
say how.  Both are compiled for ``sm_90a`` on first use with the port's
other kernels (:mod:`..build`) and bound with ``ctypes``.

:func:`flash_attention_bhsd` takes CUDA tensors only and launches the
kernel of their type or raises; the plain version for CPU tensors is
:func:`.ref.flash_ref`, and :mod:`.ops` picks between the two by the
tensors' device.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ..build import kernel_fn

MAX_HEAD_DIM = 256
VARIANTS = {torch.bfloat16: "mma_bf16", torch.float32: "mma_tf32x3"}
# the kernels' head-dim buckets as compiled: (DK, DV, query rows a block =
# 16 · warps, keys a K/V tile); the first bucket holding (hd, hdv) runs
_BUCKETS = {
    4: ((32, 32, 64, 64), (64, 64, 64, 64), (80, 80, 128, 64),   # tf32x3
        (128, 128, 64, 32), (192, 128, 64, 32), (256, 256, 128, 16)),
    2: ((256, 256, 128, 64),),                                   # mma_bf16
}
_ENTRIES = {"mma_bf16": "flash_attention_fwd_bf16_mma",
            "mma_tf32x3": "flash_attention_fwd_f32_tf32x3"}


@functools.cache
def _kernel(variant: str):
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return kernel_fn(_ENTRIES[variant],
                     [p, p, p, p, i, i, i, i, i, i, i, f, i, i, f, p])


def reset_launches() -> None:
    """Set the launch counts (total, per variant and per case) to 0."""
    flash_attention_bhsd.launches = 0
    flash_attention_bhsd.launches_by_variant = dict.fromkeys(_ENTRIES, 0)
    flash_attention_bhsd.launches_by_case = {}


def _launch(q, k, v, out, *, causal, window, softcap, scale,
            stream) -> None:
    """Launch the kernel of q's dtype on checked tensors and count it."""
    variant = VARIANTS[q.dtype]
    b, hq, sq, hd = q.shape
    _, hkv, skv, hdv = v.shape
    err = _kernel(variant)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq,
        hkv, sq, skv, hd, hdv, float(scale), int(causal), window or 0,
        float(softcap or 0.0), stream)
    if err:
        raise RuntimeError(
            f"flash_attention_bhsd: {variant} kernel launch failed with "
            f"cudaError {err} (q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"hdv={hdv}, {q.dtype})")
    flash_attention_bhsd.launches += 1
    flash_attention_bhsd.launches_by_variant[variant] += 1
    case = (variant, hd, hdv, window, softcap)
    by_case = flash_attention_bhsd.launches_by_case
    by_case[case] = by_case.get(case, 0) + 1


def flash_attention_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: Optional[int] = None,
                         softcap: Optional[float] = None,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Flash attention on the card, head-major layouts.

    q: (B, Hq, Sq, hd); k: (B, Hkv, Skv, hd); v: (B, Hkv, Skv, hdv), one
    dtype (bfloat16: the bf16 kernel; float32: the three-pass TF32 one),
    contiguous, on one CUDA device, with Hq % Hkv == 0 and hd, hdv ≤ 256.
    Any Sq and Skv: the kernels mask the ragged edges themselves.  Returns
    (B, Hq, Sq, hdv) in q.dtype (fp32 accumulation and softmax).  Adds one
    to ``flash_attention_bhsd.launches``, to its variant's entry of
    ``flash_attention_bhsd.launches_by_variant`` and to its case's entry
    of ``flash_attention_bhsd.launches_by_case`` (keyed by ``(variant,
    hd, hdv, window, softcap)``) per kernel launch.
    """
    if q.device.type != "cuda":
        raise ValueError(
            f"flash_attention_bhsd: q is on {q.device}; the kernel takes "
            f"CUDA tensors (CPU tensors go to ref.flash_ref)")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype or t.dim() != 4 \
                or not t.is_contiguous():
            raise ValueError(
                f"flash_attention_bhsd: {name} must be a contiguous 4-d "
                f"tensor of q's dtype {q.dtype} on {q.device}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device} "
                f"contiguous={t.is_contiguous()}")
    if q.dtype not in VARIANTS:
        raise ValueError(f"flash_attention_bhsd: dtype {q.dtype} not in "
                         f"{tuple(VARIANTS)}")
    b, hq, sq, hd = q.shape
    _, hkv, skv, hdk = k.shape
    hdv = v.shape[-1]
    if k.shape[0] != b or v.shape[:3] != k.shape[:3] or hdk != hd:
        raise ValueError(f"flash_attention_bhsd: shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)} disagree")
    if hkv < 1 or hq % hkv:
        raise ValueError(f"flash_attention_bhsd: Hq={hq} is not a multiple "
                         f"of Hkv={hkv}")
    if not (1 <= hd <= MAX_HEAD_DIM and 1 <= hdv <= MAX_HEAD_DIM):
        raise ValueError(f"flash_attention_bhsd: head dims hd={hd}, "
                         f"hdv={hdv} must lie in [1, {MAX_HEAD_DIM}]")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention_bhsd: window={window} < 1")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"flash_attention_bhsd: softcap={softcap} <= 0")
    out = torch.empty(b, hq, sq, hdv, dtype=q.dtype, device=q.device)
    if out.numel() == 0 or skv == 0:
        return out.zero_()
    _launch(q, k, v, out, causal=causal, window=window, softcap=softcap,
            scale=scale if scale is not None else hd ** -0.5,
            stream=torch.cuda.current_stream(q.device).cuda_stream)
    return out


reset_launches()


def hbm_bytes_model(b: int, hq: int, hkv: int, sq: int, skv: int,
                    hd: int, hdv: int, *, block_q: int | None = None,
                    itemsize: int = 4, causal: bool = False,
                    window: int | None = None) -> int:
    """Global-memory bytes the kernel's schedule requests for one call.

    Each block (a tile of ``block_q`` query rows of one query head) reads
    its Q rows once, writes its output rows once, and reads the K and V
    rows of each key tile it visits once.  The key tile, and by default
    ``block_q``, are those of the bucket that holds (hd, hdv) in the
    kernel of ``itemsize``: 4 is the three-pass TF32 kernel
    (``flash_attention_tf32x3.cu``), 2 the bf16 one
    (``flash_attention_mma.cu``: 128 query rows, 64-key tiles).  Rows past
    Skv are zero-filled, not read.  Where the TPU kernel's schedule
    (``repro/kernels/flash_attn/flash.py::hbm_bytes_model``) differs:

    - GQA: every query head's blocks re-read its kv head's K and V (a
      block serves one query head), where the TPU model counts K/V per kv
      head; with g = Hq / Hkv = 1 the two agree.
    - Causal (and window) tiles the kernel skips are not read or counted
      (``causal``, ``window``: the kernel's key-tile range per query
      tile); the TPU model reads every key for every query block.  With
      ``causal=False`` and no window, g = 1 and the same ``block_q``, the
      two models give the same bytes.
    """
    bucket = next((c for c in _BUCKETS.get(itemsize, ())
                   if hd <= c[0] and hdv <= c[1]), None)
    if bucket is None:
        raise ValueError(f"hbm_bytes_model: no kernel of itemsize "
                         f"{itemsize} takes hd={hd}, hdv={hdv}")
    block_q = block_q or bucket[2]
    block_kv = bucket[3]
    n_kv_tiles = -(-skv // block_kv)
    keys = 0
    for q0 in range(0, sq, block_q):
        j_hi = n_kv_tiles - 1
        if causal:
            j_hi = min(j_hi, (min(q0 + block_q, sq) - 1) // block_kv)
        j_lo = (q0 - window + 1) // block_kv \
            if window and q0 - window + 1 > 0 else 0
        keys += max(0, min((j_hi + 1) * block_kv, skv) - j_lo * block_kv)
    q_o = b * hq * sq * (hd + hdv)
    kv = b * hq * keys * (hd + hdv)
    return (q_o + kv) * itemsize
