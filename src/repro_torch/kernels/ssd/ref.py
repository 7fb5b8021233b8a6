"""Plain PyTorch versions for the SSD kernel.

- :func:`ssd_intra_chunk_ref` computes what the intra-chunk kernel
  computes, batched over (batch, chunk, head): the CPU path of
  :func:`repro_torch.kernels.ssd.ops.ssd_chunked_fused`, and the version
  ``chip_smoke.py`` holds the CUDA kernel against on the card.
- :func:`ssd_dense_ref` is the dense dual (quadratic) form over the whole
  sequence, independent of any chunking: the oracle that arbitrates
  between the chunked paths (small shapes only; it materializes S×S).
"""
from __future__ import annotations

import torch


def ssd_intra_chunk_ref(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                        b_mat: torch.Tensor, c_mat: torch.Tensor, *,
                        chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B,S,H,P); dt: (B,S,H); a: (H,); b/c: (B,S,N); S % chunk == 0.
    Returns (y_intra (B,S,H,P), states (B,nc,H,P,N)) in fp32."""
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    q = chunk
    nc = s // q
    xh = x.float().reshape(bsz, nc, q, h, p).permute(0, 1, 3, 2, 4)
    dth = dt.float().reshape(bsz, nc, q, h).permute(0, 1, 3, 2)  # (B,nc,H,Q)
    bc = b_mat.float().reshape(bsz, nc, 1, q, n)
    cc = c_mat.float().reshape(bsz, nc, 1, q, n)
    da = dth * a.float()[:, None]
    cs = torch.cumsum(da, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]                      # (…,Q,Q)
    causal = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()
    l_mat = torch.where(causal, torch.exp(seg), 0.0)
    scores = cc @ bc.transpose(-1, -2)                             # (B,nc,1,Q,Q)
    m = scores * l_mat * dth[..., None, :]
    y = (m @ xh).permute(0, 1, 3, 2, 4).reshape(bsz, s, h, p)
    w = torch.exp(cs[..., -1:] - cs) * dth                         # (B,nc,H,Q)
    st = xh.transpose(-1, -2) @ (bc * w[..., None])                # (B,nc,H,P,N)
    return y, st


def ssd_dense_ref(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                  b_mat: torch.Tensor, c_mat: torch.Tensor) -> torch.Tensor:
    """x: (B,S,H,P); dt: (B,S,H); a: (H,); b/c: (B,S,N) → (B,S,H,P).

    y[t] = Σ_{s≤t} C[t]·exp(Σ_{s<k≤t} da[k])·dt[s]·(B[s]·x[s])."""
    s = x.shape[1]
    da = dt * a
    cs = torch.cumsum(da, dim=1)
    seg = cs[:, :, None] - cs[:, None, :]                          # (B,T,S,H)
    mask = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    l_mat = torch.where(mask[None, :, :, None], torch.exp(seg), 0.0)
    scores = torch.einsum("btn,bsn->bts", c_mat, b_mat)
    m = scores[..., None] * l_mat * dt[:, None]
    return torch.einsum("btsh,bshp->bthp", m, x)
