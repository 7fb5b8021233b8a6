"""Token-major entry point of flash attention.

Takes the model's (B, S, H, hd) layout, transposes to the kernel's
head-major layout and back, and picks by device: the CUDA kernel
(:func:`.flash.flash_attention_bhsd`) on CUDA tensors, where a failure to
build or launch raises, and the plain version (:func:`.ref.flash_ref`) on
CPU tensors.  There is no other path.

The kernel has no backward, in this package or in the JAX package: a call
with grad mode on and an input that requires grad raises on either device
(:func:`..refuse_grad`).
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import refuse_fake, refuse_grad
from .flash import flash_attention_bhsd
from .ref import flash_ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, Sq, Hq, hd); k/v: (B, Skv, Hkv, hd[_v]) → (B, Sq, Hq, hd_v).
    Forward only: raises under grad mode if an input requires grad."""
    refuse_grad("flash_attention", q, k, v)
    refuse_fake("flash_attention", q, k, v)
    qt = q.transpose(1, 2).contiguous()
    kt = k.transpose(1, 2).contiguous()
    vt = v.transpose(1, 2).contiguous()
    fn = flash_attention_bhsd if qt.is_cuda else flash_ref
    out = fn(qt, kt, vt, causal=causal, window=window, softcap=softcap,
             scale=scale)
    return out.transpose(1, 2)
