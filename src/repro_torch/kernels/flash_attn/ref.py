"""Plain PyTorch version of the flash-attention kernel (head-major layout).

The CPU path of :func:`repro_torch.kernels.flash_attn.ops.flash_attention`,
and the version ``chip_smoke.py`` holds the CUDA kernel against on the
card.  Dense math: it materializes the full score matrix.
"""
from __future__ import annotations

from typing import Optional

import torch


def flash_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              softcap: Optional[float] = None,
              scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, Hq, Sq, hd); k/v: (B, Hkv, Skv, hd[_v]) → (B, Hq, Sq, hd_v) in
    q.dtype, fp32 math.  A query row that sees no key gets the softmax of
    its all-masked row (the mean of v), as in the JAX oracle; the kernel
    gives 0 there — no caller of the model makes such rows."""
    hq, sq, hd = q.shape[1], q.shape[2], q.shape[3]
    hkv, skv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = scale if scale is not None else hd ** -0.5
    kq = k.repeat_interleave(g, dim=1).float()
    vq = v.repeat_interleave(g, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kq) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    qi = torch.arange(sq, device=q.device)[:, None]
    kj = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones(sq, skv, dtype=torch.bool, device=q.device)
    if causal:
        mask &= kj <= qi
    if window is not None:
        mask &= kj > qi - window
    s = torch.where(mask, s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vq).to(q.dtype)
