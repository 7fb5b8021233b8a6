"""Full chunked SSD through the intra-chunk kernel plus the inter-chunk
recurrence in torch ops: the port's ``ssd_chunked_pallas``, with the same
signature and semantics as :func:`repro_torch.nn.ssm.ssd_chunked`.

Picks by device: the CUDA kernel (:func:`.ssd.ssd_intra_chunk`) on CUDA
tensors, where a failure to build or launch raises, and the plain version
(:func:`.ref.ssd_intra_chunk_ref`) on CPU tensors.  There is no other path.

The kernel has no backward, in this package or in the JAX package: a call
of :func:`ssd_chunked_fused` with grad mode on and an input that requires
grad raises on either device (:func:`..refuse_grad`).

:func:`pad_to_chunk` and :func:`inter_chunk` are shared with the plain-torch
``ssd_chunked``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import refuse_fake, refuse_grad
from .ref import ssd_intra_chunk_ref
from .ssd import ssd_intra_chunk


def pad_to_chunk(chunk: int, x, dt, b_mat, c_mat):
    """Pad the sequence up to a multiple of ``chunk``: dt = 0 ⇒ decay 1 and
    no state update, so the tail is inert."""
    pad = -x.shape[1] % chunk
    if not pad:
        return x, dt, b_mat, c_mat
    return (F.pad(x, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad)),
            F.pad(b_mat, (0, 0, 0, pad)), F.pad(c_mat, (0, 0, 0, pad)))


def inter_chunk(states, da_h, cc):
    """The recurrence that carries the state across chunks, and its
    contribution to the outputs.

    states : (B, nc, H, P, N) each chunk's boundary state
    da_h   : (B, nc, H, Q)    dt·a, head-major
    cc     : (B, nc, Q, N)    C per chunk
    Returns (y_inter (B, nc, H, Q, P), final state (B, H, P, N))."""
    bsz, nc, h, p, n = states.shape
    chunk_decay = torch.exp(da_h.sum(dim=-1))              # (B,nc,H)
    carry = states.new_zeros(bsz, h, p, n)
    prev = []
    for c in range(nc):
        prev.append(carry)                                 # state BEFORE chunk
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                 # (B,nc,H,P,N)
    # decay from the chunk's start
    ch = cc[:, :, None] * torch.exp(torch.cumsum(da_h, dim=-1))[..., None]
    return ch @ prev_states.transpose(-1, -2), carry


def ssd_chunked_fused(x, dt, a, b_mat, c_mat, chunk: int):
    """x: (B,S,H,P); dt: (B,S,H); a: (H,); b/c: (B,S,N).
    Returns (y (B,S,H,P) fp32, final_state (B,H,P,N)).  Forward only:
    raises under grad mode if an input requires grad."""
    refuse_grad("ssd_chunked_fused", x, dt, a, b_mat, c_mat)
    refuse_fake("ssd_chunked_fused", x, dt, a, b_mat, c_mat)
    bsz, s_orig, h, p = x.shape
    n = b_mat.shape[-1]
    x, dt, b_mat, c_mat = pad_to_chunk(
        chunk, x.float(), dt.float(), b_mat.float(), c_mat.float())
    s = x.shape[1]
    nc = s // chunk
    a = a.float()
    fn = ssd_intra_chunk if x.is_cuda else ssd_intra_chunk_ref
    y_intra, states = fn(x.contiguous(), dt.contiguous(), a.contiguous(),
                         b_mat.contiguous(), c_mat.contiguous(), chunk=chunk)
    da_h = (dt * a).reshape(bsz, nc, chunk, h).transpose(2, 3)  # (B,nc,H,Q)
    y_inter, final = inter_chunk(states, da_h,
                                 c_mat.reshape(bsz, nc, chunk, n))
    y_inter = y_inter.transpose(2, 3).reshape(bsz, s, h, p)
    return (y_intra + y_inter)[:, :s_orig], final
